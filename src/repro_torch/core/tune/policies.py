"""Search POLICIES: who proposes candidates, and when to stop paying for them.

The port's own copy of ``repro.core.tune.policies`` (pure numpy; nothing
here touches a tensor).  The engine (``core/tune/engine.py``) solves one
sigma group's worth of candidates in one stacked blocked-CG; a
:class:`SearchPolicy` drives it through four hooks:

  * ``propose(space, rng)`` — turn the search space into the ordered list of
    :class:`~repro_torch.core.tune.engine.SigmaGroup` the engine will solve.
  * ``rungs(group, max_iters)`` — iteration checkpoints at which the engine
    scores every in-flight candidate mid-solve (one kernel sweep each).
  * ``prune(group, rung_index, it, scores, active)`` — given those scores,
    a bool mask of candidates to freeze; None keeps everyone.
  * ``observe(group, records)`` — the group's final CV records, for policies
    that adapt later proposals.

:class:`GridSearch` and :class:`RandomSearch` never prune;
:class:`SuccessiveHalving` prunes losing (lam[, weight]) candidates at
geometric rungs mid-solve, so the stacked solve ends as soon as the
survivors converge.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.tune.engine import SigmaGroup

__all__ = [
    "POLICIES",
    "GridSearch",
    "RandomSearch",
    "SearchPolicy",
    "SuccessiveHalving",
    "TuneSpace",
    "make_policy",
]

#: the built-in policy names ``tune(policy=...)`` accepts
POLICIES = ("grid", "random", "halving")


@dataclasses.dataclass(frozen=True)
class TuneSpace:
    """The search space a policy turns into sigma groups.

    ``weight_samples`` (an (M, q) matrix) marks the multi-kernel weight
    axis — every sigma group then carries all M weight candidates;
    ``num_samples`` is the single-kernel random-search budget over the
    (sigma, lam) grid.
    """

    sigmas: tuple[float, ...]
    lams: tuple[float, ...]
    num_samples: int | None = None
    weight_samples: Any = None  # np.ndarray (M, q) | None


@runtime_checkable
class SearchPolicy(Protocol):
    """The propose/observe/prune contract the tuning driver runs against."""

    name: str

    def propose(
        self, space: TuneSpace, rng: np.random.Generator
    ) -> list[SigmaGroup]:
        """Ordered sigma groups to solve (each = one stacked blocked-CG)."""
        ...

    def rungs(self, group: SigmaGroup, max_iters: int) -> tuple[int, ...]:
        """Iteration checkpoints for mid-solve scoring (empty = none)."""
        ...

    def prune(
        self,
        group: SigmaGroup,
        rung_index: int,
        it: int,
        scores: np.ndarray,
        active: np.ndarray,
    ) -> "np.ndarray | None":
        """(n_cand,) bool mask of candidates to freeze now, or None."""
        ...

    def observe(self, group: SigmaGroup, records: list[dict]) -> None:
        """Final CV records of a solved group (hook for adaptive policies)."""
        ...


def _grid_groups(space: TuneSpace) -> list[SigmaGroup]:
    """Full cross product, grouped by sigma in first-seen order.  A sigma
    may be a scalar or a per-kernel tuple (multi-kernel bandwidth vectors) —
    ``canon_sigma`` makes either a hashable group key."""
    from repro_torch.core.tune.engine import canon_sigma

    by_sigma: dict[Any, list[float]] = {}
    if space.weight_samples is None:
        # single-kernel legacy grouping: a repeated sigma repeats its lams
        for s in space.sigmas:
            for lv in space.lams:
                by_sigma.setdefault(canon_sigma(s), []).append(float(lv))
    else:
        # multi-kernel legacy grouping: sigmas dedup (dict.fromkeys)
        for s in dict.fromkeys(canon_sigma(s) for s in space.sigmas):
            by_sigma[s] = [float(lv) for lv in space.lams]
    return [
        SigmaGroup(sigma=s, lam_list=tuple(lams),
                   weight_samples=space.weight_samples)
        for s, lams in by_sigma.items()
    ]


@dataclasses.dataclass
class GridSearch:
    """Exhaustive search: every (sigma, lam[, weight]) candidate runs to the
    stacked solve's convergence; nothing is ever pruned (the legacy
    ``search="grid"``)."""

    name: str = "grid"

    def propose(
        self, space: TuneSpace, rng: np.random.Generator
    ) -> list[SigmaGroup]:
        """All sigma groups with the full lam list (and all weight rows)."""
        if space.num_samples is not None:
            raise ValueError(
                "num_samples only applies to search='random'; grid search "
                "always runs the full cross product"
            )
        return _grid_groups(space)

    def rungs(self, group: SigmaGroup, max_iters: int) -> tuple[int, ...]:
        """No mid-solve scoring."""
        return ()

    def prune(self, group, rung_index, it, scores, active):
        """Never prunes."""
        return None

    def observe(self, group: SigmaGroup, records: list[dict]) -> None:
        """Stateless — nothing to adapt."""


@dataclasses.dataclass
class RandomSearch:
    """Random subset of the (sigma, lam) grid (``num_samples`` draws without
    replacement, the rng stream of the legacy ``search="random"``); on the
    multi-kernel path the weight matrix IS the random axis and every sigma
    group carries it whole."""

    name: str = "random"

    def propose(
        self, space: TuneSpace, rng: np.random.Generator
    ) -> list[SigmaGroup]:
        """Sampled (sigma, lam) grid points grouped by sigma (single-kernel);
        the full sigma x weight-sample cross product otherwise."""
        if space.weight_samples is not None:
            # the weight matrix was already randomly drawn — the sigma/lam
            # axes stay exhaustive, exactly like tune_multikernel always did
            return _grid_groups(space)
        from repro_torch.core.tune.engine import canon_sigma

        grid = [
            (canon_sigma(s), float(lv))
            for s in space.sigmas
            for lv in space.lams
        ]
        k = (len(grid) if space.num_samples is None
             else min(int(space.num_samples), len(grid)))
        if k < 1:
            raise ValueError("random search needs num_samples >= 1")
        picks = rng.choice(len(grid), size=k, replace=False)
        cands = [grid[i] for i in sorted(picks)]
        by_sigma: dict[Any, list[float]] = {}
        for s, lv in cands:
            by_sigma.setdefault(s, []).append(lv)
        return [
            SigmaGroup(sigma=s, lam_list=tuple(lams))
            for s, lams in by_sigma.items()
        ]

    def rungs(self, group: SigmaGroup, max_iters: int) -> tuple[int, ...]:
        """No mid-solve scoring."""
        return ()

    def prune(self, group, rung_index, it, scores, active):
        """Never prunes."""
        return None

    def observe(self, group: SigmaGroup, records: list[dict]) -> None:
        """Stateless — nothing to adapt."""


@dataclasses.dataclass
class SuccessiveHalving:
    """Successive halving over each sigma group's candidates, pruned
    MID-SOLVE.

    With n candidates and reduction factor ``eta``, the group's stacked
    blocked-CG hits ``R = ceil(log_eta n)`` rungs at iterations
    ``max_iters / eta^(R - j)`` (j = 0..R-1).  At rung j the engine scores
    every candidate from the current block (one kernel sweep) and this
    policy keeps the best ``ceil(n / eta^(j+1))``, freezing the columns of
    the rest via ``blocked_cg``'s external freeze hook.  The solve then runs
    only until the survivors converge — pruning the slow, losing tail
    (typically the smallest lams: worst-conditioned AND overfit) is what
    turns into kernel-sweep savings.  The top candidate at every rung is
    never pruned, so when the winner is separable by the first rung the
    halving search returns the exhaustive grid's best config at a strict
    sweep discount.
    """

    eta: float = 3.0
    name: str = "halving"

    def __post_init__(self) -> None:
        if not self.eta > 1.0:
            raise ValueError(f"halving_eta must be > 1; got {self.eta}")

    def propose(
        self, space: TuneSpace, rng: np.random.Generator
    ) -> list[SigmaGroup]:
        """The full grid — halving prunes instead of subsampling."""
        if space.num_samples is not None:
            raise ValueError(
                "num_samples does not apply to policy='halving'; halving "
                "starts from the full grid and prunes at rungs"
            )
        return _grid_groups(space)

    def n_rungs(self, n_candidates: int) -> int:
        """Halvings needed to reach one survivor."""
        if n_candidates <= 1:
            return 0
        return int(math.ceil(math.log(n_candidates) / math.log(self.eta)))

    def rungs(self, group: SigmaGroup, max_iters: int) -> tuple[int, ...]:
        """Geometric iteration checkpoints ``max_iters / eta^(R - j)``."""
        n_r = self.n_rungs(group.n_candidates)
        marks = sorted({
            max(1, int(max_iters / self.eta ** (n_r - j)))
            for j in range(n_r)
        })
        return tuple(m for m in marks if m < max_iters)

    def prune(
        self,
        group: SigmaGroup,
        rung_index: int,
        it: int,
        scores: np.ndarray,
        active: np.ndarray,
    ) -> "np.ndarray | None":
        """Keep the best ``ceil(n / eta^(rung_index + 1))`` active
        candidates; freeze the rest."""
        n_cand = len(scores)
        n_keep = max(1, int(math.ceil(n_cand / self.eta ** (rung_index + 1))))
        act_idx = np.nonzero(active)[0]
        if len(act_idx) <= n_keep:
            return None
        order = act_idx[np.argsort(scores[act_idx], kind="stable")]
        mask = np.zeros(n_cand, bool)
        mask[order[n_keep:]] = True
        return mask

    def observe(self, group: SigmaGroup, records: list[dict]) -> None:
        """Stateless across groups (rung state lives in the engine)."""


def make_policy(name_or_policy, *, halving_eta: float = 3.0) -> SearchPolicy:
    """Resolve ``tune(policy=...)``: a name from :data:`POLICIES` or an
    object already implementing :class:`SearchPolicy`."""
    if not isinstance(name_or_policy, str):
        if isinstance(name_or_policy, SearchPolicy):
            return name_or_policy
        raise ValueError(
            f"policy must be one of {POLICIES} or a SearchPolicy instance; "
            f"got {name_or_policy!r}"
        )
    if name_or_policy == "grid":
        return GridSearch()
    if name_or_policy == "random":
        return RandomSearch()
    if name_or_policy == "halving":
        return SuccessiveHalving(eta=float(halving_eta))
    raise ValueError(
        f"unknown policy {name_or_policy!r}; accepted: {POLICIES}"
    )
