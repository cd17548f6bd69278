"""Unified solver entry point — the port of ``repro.core.solver_api.solve``.

``solve(problem, method, **kw)`` keeps the reference's contract for the
methods ported so far, ``"askotch"`` and ``"skotch"``: multi-RHS problems,
per-head convergence in the history records, unknown options failing fast
with the accepted list, and the universal ``kernel=``/``weights=``/
``precision=`` overrides with the bf16 tolerance warning.  Every other
method of :data:`METHODS` raises ``NotImplementedError`` ("not yet ported").
The ``backend`` option is gone: the problem's tensors decide the device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.core import askotch
from repro_torch.core.krr import KRRProblem
from repro_torch.kernels.precision import check_precision

METHODS = (
    "askotch",
    "skotch",
    "pcg-nystrom",
    "pcg-rpcholesky",
    "pcg-rff",
    "cg",
    "falkon",
    "eigenpro",
    "direct",
    "dc",
)

#: the methods this package implements so far
PORTED_METHODS = ("askotch", "skotch")

#: tolerances below this are unreachable with bf16 kernel tiles; solve()
#: warns, it does not silently stall
BF16_TOL_FLOOR = 1e-6

_ASKOTCH_CFG_KEYS = (
    "block_size", "rank", "rho_mode", "sampling", "precond",
    "mu", "nu", "stable_inv", "powering_iters",
)
_ASKOTCH_SOLVE_KEYS = (
    "max_iters", "tol", "eval_every", "seed", "time_budget_s", "callback", "w0",
)

#: accepted keyword options per ported method
METHOD_OPTIONS: dict[str, tuple[str, ...]] = {
    "askotch": _ASKOTCH_CFG_KEYS + _ASKOTCH_SOLVE_KEYS,
    "skotch": _ASKOTCH_CFG_KEYS + _ASKOTCH_SOLVE_KEYS,
}


@dataclasses.dataclass
class SolveOutput:
    method: str
    w: torch.Tensor
    history: list[dict]
    info: dict[str, Any]
    predict_fn: Any  # (x_test) -> predictions ((m,) or (m, t))


def _validate_options(method: str, kw: dict) -> None:
    accepted = METHOD_OPTIONS[method]
    unknown = sorted(set(kw) - set(accepted))
    if unknown:
        raise ValueError(
            f"unknown option(s) {unknown} for method {method!r}; "
            f"accepted: {sorted(accepted) or '(none)'}"
        )


def _head_info(problem: KRRProblem, history: list[dict]) -> dict[str, Any]:
    info: dict[str, Any] = {"t": problem.t}
    if history and "rel_residual_per_head" in history[-1]:
        info["rel_residual_per_head"] = history[-1]["rel_residual_per_head"]
    return info


def solve(problem: KRRProblem, method: str = "askotch", **kw) -> SolveOutput:
    """Solve (K + lam I) W = Y.

    Args:
      problem: the :class:`~repro_torch.core.krr.KRRProblem`; ``problem.y``
        may be (n,) or (n, t) one-vs-all heads.
      method: one of :data:`METHODS`; only :data:`PORTED_METHODS` run.
      **kw: exactly :data:`METHOD_OPTIONS[method]`, plus the universal
        ``kernel=``, ``weights=`` and ``precision=`` overrides and
        ``telemetry=`` (must be None until the telemetry slice).

    Returns:
      A :class:`SolveOutput`: ``w`` ((n,) or (n, t)), the ``history``
      records, an ``info`` dict and a ``predict_fn`` mapping (q, d) queries
      to (q[, t]) scores.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; available: {METHODS}")
    telemetry = kw.pop("telemetry", None)
    if "kernel" in kw or "weights" in kw or "precision" in kw:
        problem = dataclasses.replace(
            problem,
            **{k: kw.pop(k) for k in ("kernel", "weights", "precision") if k in kw},
        )
    check_precision(problem.precision)
    if problem.precision == "bf16" and kw.get("tol", 1.0) < BF16_TOL_FLOOR:
        warnings.warn(
            f"tol={kw['tol']:g} is below the bf16 kernel-tile resolution "
            f"(~{BF16_TOL_FLOOR:g} relative residual); the solve will stall "
            'short of it — use precision="f32" for machine-precision targets',
            stacklevel=2,
        )
    if method not in PORTED_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not yet ported to repro_torch; ported: {PORTED_METHODS}"
        )
    _validate_options(method, kw)
    cfg_kw = {k: kw.pop(k) for k in _ASKOTCH_CFG_KEYS if k in kw}
    cfg = askotch.ASkotchConfig(accelerated=(method == "askotch"), **cfg_kw)
    res = askotch.solve(problem, cfg, telemetry=telemetry, **kw)
    return SolveOutput(
        method=method,
        w=res.w,
        history=res.history,
        info={"iters": res.iters, "converged": res.converged,
              "wall_time_s": res.wall_time_s, **_head_info(problem, res.history)},
        predict_fn=lambda xt: problem.predict(res.w, xt),
    )
