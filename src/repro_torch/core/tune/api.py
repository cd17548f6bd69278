"""Tuning entry points: policy-driven searches over the stacked engine —
the port of ``repro.core.tune.api``.

``tune`` / ``tune_multikernel`` take the reference's signatures and
defaults: grid / random search, shared vs naive strategy, ``policy=``
("grid" | "random" | "halving" or a ``SearchPolicy``), ``halving_eta=`` and
``sigma_continuation=``.  One driver (:func:`run_search`) serves both: the
single-kernel sweep is the multi-kernel sweep without a weight matrix (the
engine's q = 1 case).

``telemetry=`` records a search span, per-sigma-group spans and canonical
trace events (solver ``"tune"``, with running ``sweeps``) from every
stacked solve.  ``mesh=`` (a ``repro_torch.distributed.meshes.SolverMesh``)
runs every candidate over a ``ShardedKernelOperator``; every policy runs
unchanged over a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.krr import KRRProblem
from repro_torch.core.operator import as_multirhs
from repro_torch.core.tune.engine import (
    Continuation,
    SigmaGroup,
    SweepCounter,
    canon_sigma,
    fold_avg_w0,
    make_folds,
    naive_candidate_solve,
    operator_for,
    score_fold,
    solve_sigma_group,
)
from repro_torch.core.tune.policies import (
    POLICIES,
    SearchPolicy,
    TuneSpace,
    make_policy,
)
from repro_torch.obs.telemetry import as_telemetry

SEARCHES = ("grid", "random")
STRATEGIES = ("shared", "naive")

__all__ = [
    "SEARCHES",
    "STRATEGIES",
    "TuneResult",
    "apply_best",
    "run_search",
    "tune",
    "tune_multikernel",
]


@dataclasses.dataclass
class TuneResult:
    """Outcome of a (sigma[, weight], lam) sweep with k-fold CV.

    Attributes:
      best: JSON-able best-config dict — ``kernel``, ``sigma``,
        ``lam_unscaled``, ``backend``, ``precision``, ``folds``, ``cv_mse``
        (plus ``weights`` for a multi-kernel sweep), the reference's keys in
        its order — consumable by :func:`apply_best`.  ``backend`` is always
        ``"auto"``: the port dispatches by the tensors' device, and the key
        keeps an exported config readable by the JAX package's serving.
      best_score: the winning mean CV validation MSE (lower is better).
      records: one dict per evaluated candidate: ``sigma``, ``lam_unscaled``,
        ``cv_mse``, ``fold_mse`` (length-k list), ``cv_acc`` (top-1
        one-vs-all accuracy) when the problem has t > 1 heads, ``weights``
        on the multi-kernel path, and ``pruned_at_rung`` when a halving
        policy froze the candidate mid-solve.
      folds / search / strategy: the sweep configuration actually run
        (``search`` is the policy name: "grid", "random", or "halving").
      sweeps: kernel-tile sweep equivalents consumed (see
        :class:`~repro_torch.core.tune.engine.SweepCounter`); the tile-sharing
        claim is ``sweeps`` staying ~s solves' worth for an s-sigma grid.
      info: extras — ``pairs``, ``n``, ``t``, ``candidates``, ``policy``,
        ``naive_sweep_estimate`` (what the per-candidate loop would cost),
        per-sigma iteration counts, ``sigma_continuation``.
      best_w0: fold-averaged weights of the winning candidate (the
        mask-supported mean of its k CV fold solutions; (n,) or (n, t)) —
        the refit warm start ``apply_best`` can thread to the solver.  None
        for the naive strategy (its fold solves are discarded).
      trace: the audit trail — one dict per candidate (aligned with
        ``records``): ``sigma``, ``lam_unscaled`` (+ ``weights``),
        ``scores`` (its CV score at every rung it was alive for, ending
        with the final score), ``iters`` (the iteration each score was
        taken at), and ``pruned_at_rung`` (0-based rung index, or None if
        it survived to the end).  ``launch/krr_tune.py --export`` includes
        it so searches are auditable.
    """

    best: dict[str, Any]
    best_score: float
    records: list[dict[str, Any]]
    folds: int
    search: str
    strategy: str
    sweeps: float
    info: dict[str, Any]
    best_w0: np.ndarray | None = None
    trace: list[dict[str, Any]] | None = None


def apply_best(problem: KRRProblem, result: TuneResult, *, with_w0: bool = False):
    """Return ``problem`` re-parameterized with the tuned best config —
    the refit step of tune -> refit -> serve.

    For a multi-kernel sweep (``result.best`` carries ``weights``) the
    returned problem gets the kernel tuple and winning weight vector too.
    With ``with_w0=True`` returns ``(problem, w0)`` where ``w0`` is the
    fold-averaged CV solution of the winning candidate ((n,) or (n, t), a
    tensor on the problem's device, or None under the naive strategy) —
    pass it as the solver's warm start (``solve(..., w0=w0)``) instead of
    starting from zero.
    """
    rep: dict[str, Any] = {
        "sigma": result.best["sigma"],
        "lam_unscaled": float(result.best["lam_unscaled"]),
    }
    if isinstance(rep["sigma"], (tuple, list)):
        rep["sigma"] = tuple(float(s) for s in rep["sigma"])
    else:
        rep["sigma"] = float(rep["sigma"])
    if "weights" in result.best:
        rep["kernel"] = tuple(result.best["kernel"])
        rep["weights"] = tuple(float(w) for w in result.best["weights"])
    refit = dataclasses.replace(problem, **rep)
    if with_w0:
        w0 = result.best_w0
        return refit, None if w0 is None else torch.from_numpy(w0).to(problem.device)
    return refit


def _weight_candidates(
    q: int,
    n_weight_samples: int,
    weights,
    dirichlet_alpha: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """The (M, q) weight-candidate matrix: explicit rows, or Dirichlet draws
    from the simplex (himalaya's ``solve_multiple_kernel_ridge_random_search``
    sampling scheme)."""
    if weights is not None:
        w = np.atleast_2d(np.asarray(weights, np.float32))
        if w.shape[1] != q:
            raise ValueError(
                f"weight candidates have {w.shape[1]} entries per row for "
                f"{q} kernels"
            )
        if (w < 0).any() or (w.sum(axis=1) <= 0).any():
            raise ValueError(
                "weight candidates must be nonnegative with positive row sums"
            )
        return w
    if n_weight_samples < 1:
        raise ValueError("n_weight_samples must be >= 1")
    if dirichlet_alpha <= 0:
        raise ValueError("dirichlet_alpha must be positive")
    return rng.dirichlet(
        np.full(q, float(dirichlet_alpha)), size=int(n_weight_samples)
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# the one driver behind tune() and tune_multikernel()
# ---------------------------------------------------------------------------


def run_search(
    problem: KRRProblem,
    base_problem: KRRProblem,
    space: TuneSpace,
    policy: SearchPolicy,
    *,
    folds: int,
    strategy: str,
    rank: int,
    max_iters: int,
    tol: float,
    seed: int,
    warm_start: bool,
    sigma_continuation: bool,
    mesh,
    extra_info: dict[str, Any] | None = None,
    telemetry=None,
) -> TuneResult:
    """Drive ``policy`` over the stacked engine and assemble a TuneResult.

    ``base_problem`` is what operators are built from (the multi-kernel
    entry point re-states the problem as the kernel tuple being searched);
    ``problem`` supplies ``y`` and the best-config ``precision``.  Single-
    and multi-kernel searches, all three policies and both strategies flow
    through here.  ``telemetry`` adds a per-group span and canonical trace
    events (solver ``"tune"``, with running ``sweeps``) from every stacked
    solve.
    """
    tel = as_telemetry(telemetry)
    n = problem.n
    # the single-kernel random search draws from this stream; the
    # multi-kernel weight matrix was already drawn from its own
    # default_rng(seed) before this call
    groups = policy.propose(space, np.random.default_rng(seed))
    val_folds = make_folds(n, folds, np.random.default_rng(seed + 1))
    k = len(val_folds)
    y2, _ = as_multirhs(problem.y)
    y_np = y2.cpu().numpy()
    t = y_np.shape[1]
    counter = SweepCounter()
    squeeze_w0 = problem.y.ndim == 1

    records: list[dict[str, Any]] = []
    trace: list[dict[str, Any]] = []
    iters_by_sigma: dict[float, int] = {}
    best_w0: np.ndarray | None = None
    best_mse_so_far = np.inf
    cont: Continuation | None = None

    for group in groups:
        params = group.candidate_params()
        if strategy == "shared":
            op = operator_for(base_problem, group.sigma, mesh)
            rung_iters = policy.rungs(group, max_iters)
            # the group ends in a host read of its predictions, so the span
            # covers the device work
            with tel.span("tune/group", sigma=group.sigma,
                          candidates=group.n_candidates):
                gr = solve_sigma_group(
                    op, y_np, group, val_folds, rank=min(rank, n),
                    max_iters=max_iters, tol=tol, seed=seed,
                    warm_start=warm_start, counter=counter,
                    rung_iters=rung_iters,
                    prune_fn=(
                        lambda ri, it, scores, active, g=group: policy.prune(
                            g, ri, it, scores, active
                        )
                    ),
                    continuation=cont,
                    want_continuation=sigma_continuation,
                    recorder=tel.recorder(
                        "tune", sweep_counter=counter, n=n
                    ) if tel.enabled else None,
                )
            iters_by_sigma[group.sigma] = gr.iters
            cont = gr.continuation  # None unless sigma_continuation
            group_records: list[dict[str, Any]] = []
            for c, p in enumerate(params):
                col0 = c * k * t
                fold_mse, fold_acc = [], []
                for j, val in enumerate(val_folds):
                    cols = slice(col0 + j * t, col0 + (j + 1) * t)
                    mse, acc = score_fold(gr.preds[val, cols], y_np[val])
                    fold_mse.append(mse)
                    fold_acc.append(acc)
                rec = _record(p, fold_mse, fold_acc, t)
                pruned = gr.pruned_at_rung.get(c)
                if pruned is not None:
                    rec["pruned_at_rung"] = pruned
                group_records.append(rec)
                records.append(rec)
                trace.append({
                    **p,
                    "scores": [
                        r["cv_mse"][c]
                        for ri, r in enumerate(gr.rung_history)
                        if pruned is None or ri <= pruned
                    ] + [rec["cv_mse"]],
                    "iters": [
                        r["iter"]
                        for ri, r in enumerate(gr.rung_history)
                        if pruned is None or ri <= pruned
                    ] + [gr.iters],
                    "pruned_at_rung": pruned,
                })
                if pruned is None and rec["cv_mse"] < best_mse_so_far:
                    # the winner's refit warm start: mask-supported mean of
                    # its k fold solutions (computed lazily — slicing w_cols
                    # is free, keeping every candidate's block would not be).
                    # Pruned candidates are excluded: their frozen blocks are
                    # partially-converged by design
                    best_mse_so_far = rec["cv_mse"]
                    best_w0 = fold_avg_w0(gr.w_cols, col0, k, t, squeeze_w0)
            policy.observe(group, group_records)
        else:  # naive reference loop
            group_records = []
            for p in params:
                fold_mse, fold_acc = [], []
                per_fold, fold_iters = naive_candidate_solve(
                    base_problem, group.sigma, p["lam_unscaled"], val_folds,
                    rank=rank, max_iters=max_iters, tol=tol, seed=seed,
                    counter=counter, mesh=mesh, weights=p.get("weights"),
                )
                for pred, val in zip(per_fold, val_folds):
                    mse, acc = score_fold(pred, y_np[val])
                    fold_mse.append(mse)
                    fold_acc.append(acc)
                rec = _record(p, fold_mse, fold_acc, t)
                group_records.append(rec)
                records.append(rec)
                trace.append({**p, "scores": [rec["cv_mse"]],
                              "iters": [max(fold_iters)],
                              "pruned_at_rung": None})
            policy.observe(group, group_records)

    # best = argmin over SURVIVORS only: a pruned candidate's final score is
    # an early-stopped (implicitly regularized) snapshot that a converged
    # refit would not reproduce — the policy deliberately abandoned it, so it
    # cannot be the search's answer.  Every group keeps >= 1 survivor, so the
    # pool is never empty (grid/random never prune: identical to a plain
    # argmin there).
    survivor_scores = [
        r["cv_mse"] if "pruned_at_rung" not in r else np.inf for r in records
    ]
    best_i = int(np.argmin(survivor_scores))
    best_rec = records[best_i]
    best: dict[str, Any] = {
        "kernel": (
            list(base_problem.kernel)
            if isinstance(base_problem.kernel, tuple)
            else base_problem.kernel
        ),
        "sigma": best_rec["sigma"],
        "lam_unscaled": best_rec["lam_unscaled"],
        "backend": "auto",
        "precision": problem.precision,
        "folds": folds,
        "cv_mse": best_rec["cv_mse"],
    }
    if "weights" in best_rec:
        best["weights"] = best_rec["weights"]
        # keep the historical multi-kernel key order (weights after sigma)
        best = {
            "kernel": best["kernel"], "sigma": best["sigma"],
            "weights": best["weights"],
            "lam_unscaled": best["lam_unscaled"], "backend": best["backend"],
            "precision": best["precision"],
            "folds": best["folds"], "cv_mse": best["cv_mse"],
        }
    # what the per-candidate loop would have cost, in full-K sweeps: each of
    # the |cands| * k fold solves pays its own sketch + iteration sweeps over
    # ((k-1)/k * n)^2 tiles
    n_cands = sum(g.n_candidates for g in groups)
    frac = ((folds - 1) / folds) ** 2
    est_iters = max(iters_by_sigma.values()) if iters_by_sigma else max_iters
    naive_est = n_cands * folds * frac * (est_iters + 1)
    info: dict[str, Any] = {
        "pairs": counter.pairs,
        "n": n,
        "t": t,
        "candidates": n_cands,
        "policy": policy.name,
        "sigma_continuation": bool(sigma_continuation),
        "iters_by_sigma": {str(k_): v for k_, v in iters_by_sigma.items()},
        "naive_sweep_estimate": naive_est,
    }
    if extra_info:
        info.update(extra_info)
    return TuneResult(
        best=best,
        best_score=best_rec["cv_mse"],
        records=records,
        folds=folds,
        search=policy.name,
        strategy=strategy,
        sweeps=counter.sweeps(n),
        info=info,
        best_w0=best_w0,
        trace=trace,
    )


def _record(
    params: dict[str, Any], fold_mse: list[float], fold_acc: list[float], t: int
) -> dict[str, Any]:
    rec: dict[str, Any] = {
        "sigma": params["sigma"],
        "lam_unscaled": params["lam_unscaled"],
        "cv_mse": float(np.mean(fold_mse)),
        "fold_mse": fold_mse,
    }
    if t > 1:
        rec["cv_acc"] = float(np.mean(fold_acc))
    if "weights" in params:
        rec["weights"] = list(params["weights"])
    return rec


def _common_validation(
    problem: KRRProblem,
    sigmas: Sequence[float],
    lams: Sequence[float],
    folds: int,
    strategy: str,
    mesh,
    halving_eta: float,
    sigma_continuation: bool,
) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; accepted: {STRATEGIES}")
    if not sigmas or not lams:
        raise ValueError("sigmas and lams must be non-empty")
    # a sigma candidate may itself be a per-kernel bandwidth tuple
    flat_sigmas = [
        v
        for s in sigmas
        for v in (s if isinstance(s, (tuple, list)) else (s,))
    ]
    if any(s <= 0 for s in flat_sigmas) or any(lv <= 0 for lv in lams):
        raise ValueError("sigmas and lams must be positive")
    n = problem.n
    if not 2 <= folds <= n:
        raise ValueError(f"folds must be in [2, n={n}]; got {folds}")
    if not halving_eta > 1.0:
        raise ValueError(f"halving_eta must be > 1; got {halving_eta}")
    if strategy == "naive" and sigma_continuation:
        raise ValueError(
            "sigma_continuation requires strategy='shared' (the naive loop "
            "has no stacked solve to continue)"
        )
    if strategy == "naive" and mesh is not None and mesh.devices.size > 1:
        # the naive loop restricts to (k-1)/k * n rows per fold, which the
        # sharded operator would gather whole onto every device; the
        # reference loop is single-device
        raise ValueError(
            "strategy='naive' is a single-device reference loop; it supports "
            "at most a 1-device mesh (use strategy='shared' for mesh runs)"
        )


def _resolve_policy(policy, legacy_search, strategy, halving_eta) -> SearchPolicy:
    """``legacy_search`` is tune()'s old search= spelling (None when the
    entry point has no such knob); policy= supersedes it but conflicting
    explicit values are rejected."""
    if policy is None:
        policy = legacy_search
    elif isinstance(policy, str) and policy not in POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}; accepted: {POLICIES}"
        )
    resolved = make_policy(policy, halving_eta=halving_eta)
    # the conflict check covers SearchPolicy instances too (their .name is
    # the policy identity) — an explicit non-default search= must not be
    # silently overridden
    if legacy_search not in (None, "grid") and resolved.name != legacy_search:
        raise ValueError(
            f"pass either search={legacy_search!r} or "
            f"policy={resolved.name!r}, not conflicting values of both"
        )
    if strategy == "naive" and resolved.name == "halving":
        raise ValueError(
            "policy='halving' prunes columns of the stacked solve; it "
            "requires strategy='shared' (the naive loop has no shared "
            "solve to prune)"
        )
    return resolved


def tune(
    problem: KRRProblem,
    *,
    sigmas: Sequence[float] = (0.5, 1.0, 2.0),
    lams: Sequence[float] = (1e-6, 1e-4, 1e-2),
    folds: int = 5,
    search: str = "grid",
    num_samples: int | None = None,
    policy: "str | SearchPolicy | None" = None,
    halving_eta: float = 3.0,
    sigma_continuation: bool = False,
    strategy: str = "shared",
    rank: int = 100,
    max_iters: int = 200,
    tol: float = 1e-5,
    seed: int = 0,
    warm_start: bool = True,
    mesh=None,
    telemetry=None,
) -> TuneResult:
    """Policy-driven search over (sigma, lam_unscaled) with k-fold CV.

    Args:
      problem: the data container; its ``x``/``y``/``kernel``/``precision``
        are used (its tensors decide the device), its ``sigma``/
        ``lam_unscaled`` are ignored (they are what is
        being tuned).  ``y`` may be (n,) or (n, t) one-vs-all heads — all t
        heads ride the same stacked solve.
      sigmas / lams: candidate kernel bandwidths and *unscaled* regularizers
        (the solved shift is ``n_train_fold * lam_unscaled``, the paper's
        App. C.2.1 scaling — same rule :class:`KRRProblem` applies).
      folds: k for k-fold CV (2 <= k <= n); folds are a seeded shuffle-split
        shared by every candidate and both strategies.
      search: "grid" (full cross product) or "random" (``num_samples``
        candidates drawn from the grid without replacement) — the legacy
        spelling of ``policy``; still honored when ``policy`` is None.
      policy: "grid" | "random" | "halving", or a
        :class:`~repro_torch.core.tune.policies.SearchPolicy` instance.
        "halving" runs :class:`~repro_torch.core.tune.policies.SuccessiveHalving`:
        losing (lam) candidates are frozen at geometric rungs MID-SOLVE and
        the stacked solve ends when the survivors converge — strictly fewer
        kernel sweeps than the grid at equal best config when the winner
        separates early.
      halving_eta: successive-halving reduction factor (> 1; keep the best
        ~1/eta of the surviving candidates at each rung).
      sigma_continuation: seed each sigma group's sketch test matrix and
        iterate block from the previous group's Nystrom basis and solution
        instead of a fresh Gaussian / zero start — kernel matrices at nearby
        sigmas share eigenstructure, so this cuts stacked-CG iterations on
        multi-sigma grids (shared strategy only).
      strategy: "shared" — per sigma, ONE stacked blocked-CG over all
        (lam, fold, head) columns (the tile-sharing path); "naive" — an
        independent PCG solve per (sigma, lam, fold), the reference loop.
      rank: Nystrom sketch rank for the preconditioner (and warm start).
      max_iters / tol: blocked-CG budget per stacked (or per-candidate) solve.
      warm_start: start each column from the Woodbury apply of the shared
        sketch instead of zero ("shared" strategy only; costs no kernel
        sweeps).
      mesh: optional :class:`~repro_torch.distributed.meshes.SolverMesh` —
        candidates then run over a ``ShardedKernelOperator`` with x and the
        iterates row-sharded (a (1, 1) mesh is valid everywhere); every
        policy runs unchanged over a mesh.
      telemetry: optional ``repro_torch.obs.Telemetry`` — records a search
        span, per-sigma-group spans, canonical trace events from every
        stacked solve (with running ``sweeps``) and, through the engine's
        ``SweepCounter`` and ``blocked_cg``, the ``repro_kernel_pairs_total``
        and ``repro_cg_iterations_total`` counters.

    Returns:
      A :class:`TuneResult`; ``result.best`` is the serving-ready config,
      ``result.sweeps`` the kernel-tile work consumed, and ``result.trace``
      the per-candidate audit trail (rung scores + prune points).
    """
    if search not in SEARCHES:
        raise ValueError(f"unknown search {search!r}; accepted: {SEARCHES}")
    _common_validation(
        problem, sigmas, lams, folds, strategy, mesh, halving_eta, sigma_continuation,
    )
    resolved = _resolve_policy(policy, search, strategy, halving_eta)
    space = TuneSpace(
        sigmas=tuple(float(s) for s in sigmas),
        lams=tuple(float(lv) for lv in lams),
        num_samples=num_samples,
    )
    with as_telemetry(telemetry).span(
        "tune/search", n=problem.n, folds=folds, policy=resolved.name,
        strategy=strategy,
    ):
        return run_search(
            problem, problem, space, resolved,
            folds=folds, strategy=strategy, rank=rank, max_iters=max_iters,
            tol=tol, seed=seed, warm_start=warm_start,
            sigma_continuation=sigma_continuation, mesh=mesh,
            telemetry=telemetry,
        )


def tune_multikernel(
    problem: KRRProblem,
    *,
    kernels: Sequence[str] | None = None,
    sigmas: Sequence[float] = (0.5, 1.0, 2.0),
    lams: Sequence[float] = (1e-6, 1e-4, 1e-2),
    folds: int = 5,
    n_weight_samples: int = 8,
    weights=None,
    dirichlet_alpha: float = 1.0,
    policy: "str | SearchPolicy | None" = None,
    halving_eta: float = 3.0,
    sigma_continuation: bool = False,
    strategy: str = "shared",
    rank: int = 100,
    max_iters: int = 200,
    tol: float = 1e-5,
    seed: int = 0,
    warm_start: bool = True,
    mesh=None,
    telemetry=None,
) -> TuneResult:
    """Search over convex kernel combinations with k-fold CV.

    himalaya's ``solve_multiple_kernel_ridge_random_search`` draws weight
    vectors from the simplex and scores the banded per-candidate systems;
    here every (weight, lam, fold, head) candidate becomes one more COLUMN
    of the same stacked blocked-CG the (sigma, lam) tuner runs — per sigma,
    the whole c-candidate search costs ~1 solve's kernel work.

    Args:
      problem: data container; ``kernels`` defaults to ``problem.kernel``
        when that is already a tuple.  ``y`` may be (n,) or (n, t).
      kernels: the q base-kernel names of the combination.
      sigmas: candidate bandwidths, shared by all q kernels per sigma group.
      lams: candidate *unscaled* regularizers (paper App. C.2.1 scaling).
      folds: k for k-fold CV (same seeded shuffle-split as :func:`tune`).
      n_weight_samples: number of Dirichlet(``dirichlet_alpha``) weight
        draws from the simplex.
      weights: explicit (M, q) weight-candidate rows (overrides sampling;
        e.g. one-hot rows reproduce single-kernel tuning exactly).
      policy: None / "random" (the Dirichlet draws ARE the random axis) or
        "halving" — prune losing (weight, lam) candidates at rungs
        mid-solve.  "grid" is rejected: the weight axis is sampled, not
        gridded (pass explicit ``weights=`` rows for an exhaustive sweep).
      halving_eta / sigma_continuation: as in :func:`tune`.
      strategy: "shared" (the stacked engine) or "naive" (independent
        Nystrom-PCG per (sigma, weight, lam, fold) — the reference loop).
      rank / max_iters / tol / warm_start / seed / mesh / telemetry: as in
        :func:`tune`.

    Returns:
      A :class:`TuneResult`; ``best`` carries ``kernel`` (the q names),
      ``weights``, ``sigma``, ``lam_unscaled`` — refit via
      :func:`apply_best` — ``best_w0`` the winner's
      fold-averaged warm start, and ``trace`` the per-candidate audit trail.
    """
    from repro_torch.core.multikernel import canonical_kernels

    if kernels is None:
        if not isinstance(problem.kernel, tuple):
            raise ValueError(
                "tune_multikernel needs kernels=(...) or a problem whose "
                f"kernel is a tuple; got kernel={problem.kernel!r}"
            )
        kernels = problem.kernel
    kernels, _, _ = canonical_kernels(kernels, 1.0, None)
    q = len(kernels)
    _common_validation(
        problem, sigmas, lams, folds, strategy, mesh, halving_eta, sigma_continuation,
    )
    if policy is None:
        policy = "random"
    if policy == "grid":
        raise ValueError(
            "policy='grid' does not apply to the multi-kernel weight axis "
            "(it is sampled, not gridded); use policy='random' or "
            "'halving', or pass explicit weights= rows"
        )
    resolved = _resolve_policy(policy, None, strategy, halving_eta)

    rng = np.random.default_rng(seed)
    w_cands = _weight_candidates(q, n_weight_samples, weights, dirichlet_alpha, rng)
    # a sigma candidate may be one shared bandwidth (scalar) or a per-kernel
    # bandwidth vector of length q (canon_sigma keeps both hashable)
    canon_sigmas = tuple(canon_sigma(s) for s in sigmas)
    for s in canon_sigmas:
        if isinstance(s, tuple) and len(s) != q:
            raise ValueError(
                f"per-kernel sigma candidate {s} has {len(s)} entries for "
                f"{q} kernels"
            )
    space = TuneSpace(
        sigmas=canon_sigmas,
        lams=tuple(float(lv) for lv in lams),
        weight_samples=w_cands,
    )
    # the problem restated as the multi-kernel combination being searched
    mk_problem = dataclasses.replace(
        problem, kernel=kernels, sigma=1.0, weights=None
    )
    with as_telemetry(telemetry).span(
        "tune/search-multikernel", n=problem.n, folds=folds, q=q,
        policy=resolved.name, strategy=strategy,
    ):
        return run_search(
            problem, mk_problem, space, resolved,
            folds=folds, strategy=strategy, rank=rank, max_iters=max_iters,
            tol=tol, seed=seed, warm_start=warm_start,
            sigma_continuation=sigma_continuation, mesh=mesh,
            extra_info={
                "q": q,
                "kernels": list(kernels),
                "weight_samples": int(w_cands.shape[0]),
            },
            telemetry=telemetry,
        )
