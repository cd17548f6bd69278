"""Tile-sharing hyperparameter tuning: policy-driven (sigma[, weight], lam)
search with k-fold CV — the port of ``repro.core.tune``.

Two layers, as in the reference:

  * **Engine** (``engine.py``) — one stacked blocked-CG per sigma group.
    Folds are column masks, lambdas are per-column diagonal shifts, one
    Nystrom sketch per sigma preconditions and warm-starts every column,
    and multi-kernel weight candidates are per-column weight vectors on the
    fused multi-kernel matvec.  The single-kernel path is the q = 1 case of
    the multi-kernel one.
  * **Policies** (``policies.py``) — ``GridSearch`` / ``RandomSearch`` and
    ``SuccessiveHalving`` (prunes losing candidates at rungs MID-SOLVE via
    ``blocked_cg``'s external column freezing).

So for s sigmas, l lambdas, k folds and t one-vs-all heads the sweep runs s
stacked solves over ``l*k*t`` columns each (``TuneResult.sweeps`` carries
the kernel-sweep count).
"""

from repro_torch.core.tune.api import (
    SEARCHES,
    STRATEGIES,
    TuneResult,
    apply_best,
    run_search,
    tune,
    tune_multikernel,
)
from repro_torch.core.tune.engine import (
    Continuation,
    GroupResult,
    SigmaGroup,
    SweepCounter,
    solve_sigma_group,
)
from repro_torch.core.tune.policies import (
    POLICIES,
    GridSearch,
    RandomSearch,
    SearchPolicy,
    SuccessiveHalving,
    TuneSpace,
    make_policy,
)

__all__ = [
    "Continuation",
    "GridSearch",
    "GroupResult",
    "POLICIES",
    "RandomSearch",
    "SEARCHES",
    "STRATEGIES",
    "SearchPolicy",
    "SigmaGroup",
    "SuccessiveHalving",
    "SweepCounter",
    "TuneResult",
    "TuneSpace",
    "apply_best",
    "make_policy",
    "run_search",
    "solve_sigma_group",
    "tune",
    "tune_multikernel",
]
