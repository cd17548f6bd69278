"""Unified solver entry points — the port of ``repro.core.solver_api``'s
``solve`` and ``tune``.

``solve(problem, method, **kw)`` keeps the reference's contract for every
method of :data:`METHODS` (ASkotch / Skotch, the PCG family, Falkon,
EigenPro, direct and the divide-and-conquer tier ``"dc"``): multi-RHS
problems, per-head convergence in the history records, unknown options
failing fast with the accepted list, and the universal ``kernel=`` (a name
or a tuple of names: a weighted-sum multi-kernel solve) / ``weights=`` /
``precision=`` overrides with the bf16 tolerance warning.  ``mesh=`` (a
``repro_torch.distributed.meshes.SolverMesh``) runs the methods of
:data:`DIST_METHOD_OPTIONS` over a ``ShardedKernelOperator``, and runs a DC
solve's shards device-parallel.  ``tune(problem, **kw)`` routes to the
single-kernel or the multi-kernel search with the reference's option lists.
The ``backend`` option is gone: the problem's tensors (or the mesh) decide
the device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.core import askotch, direct, eigenpro, falkon, pcg
from repro_torch.core.krr import KRRProblem
from repro_torch.device import synchronize
from repro_torch.kernels.precision import check_precision
from repro_torch.obs.telemetry import as_telemetry

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

#: the methods this package implements: all of them
PORTED_METHODS = METHODS

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
_PCG_KEYS = (
    "rank", "rho_mode", "max_iters", "tol", "seed", "time_budget_s", "w0",
)
_FALKON_KEYS = ("m", "max_iters", "tol", "seed", "jitter", "time_budget_s")
_EIGENPRO_KEYS = (
    "rank", "subsample", "batch_size", "lr_scale", "epochs", "seed",
    "eval_every", "time_budget_s",
)

#: options of the divide-and-conquer tier itself (``method="dc"``); the
#: INNER solver's options (``METHOD_OPTIONS[dc_method]``) ride along
#: un-prefixed and are validated by the per-shard solve —
#: ``solve(p, "dc", dc_shards=4, dc_method="pcg-nystrom", rank=50)``
DC_METHOD_OPTIONS: tuple[str, ...] = (
    "dc_shards", "dc_partition", "dc_combiner", "dc_method",
    "dc_softmax_temp",
)

#: the PCG-family methods and their preconditioner kinds
_PCG_PRECOND = {
    "pcg-nystrom": "nystrom", "pcg-rpcholesky": "rpcholesky", "pcg-rff": "rff",
    "cg": "identity",
}

#: accepted keyword options per ported method
METHOD_OPTIONS: dict[str, tuple[str, ...]] = {
    "askotch": _ASKOTCH_CFG_KEYS + _ASKOTCH_SOLVE_KEYS,
    "skotch": _ASKOTCH_CFG_KEYS + _ASKOTCH_SOLVE_KEYS,
    **{m: _PCG_KEYS for m in _PCG_PRECOND},
    "falkon": _FALKON_KEYS,
    "eigenpro": _EIGENPRO_KEYS,
    "direct": (),
    "dc": DC_METHOD_OPTIONS,
}

_DIST_ASKOTCH_KEYS = (
    "block_size", "rank", "mu", "nu", "powering_iters",
    "max_iters", "tol", "eval_every", "seed", "time_budget_s",
)
_DIST_PCG_KEYS = (
    "rank", "rho_mode", "max_iters", "tol", "seed", "time_budget_s",
)

#: methods (and their accepted options) reachable through solve(..., mesh=...)
DIST_METHOD_OPTIONS: dict[str, tuple[str, ...]] = {
    "askotch": _DIST_ASKOTCH_KEYS,
    "skotch": _DIST_ASKOTCH_KEYS,
    "pcg-nystrom": _DIST_PCG_KEYS,
    "cg": _DIST_PCG_KEYS,
}

#: accepted keyword options of tune() (the reference's list): ``policy``
#: ("grid" | "random" | "halving" or a SearchPolicy instance),
#: ``halving_eta`` and ``sigma_continuation`` select the search policy;
#: ``search``/``num_samples`` remain the legacy grid/random spelling
TUNE_OPTIONS: tuple[str, ...] = (
    "sigmas", "lams", "folds", "search", "num_samples", "policy",
    "halving_eta", "sigma_continuation", "strategy",
    "rank", "max_iters", "tol", "seed", "warm_start", "precision",
    "telemetry",
)

#: accepted keyword options of tune() on the multi-kernel (weight-axis)
#: path — selected when ``kernels``/``n_weight_samples``/``weights`` is
#: passed or the problem's kernel is a tuple
MULTIKERNEL_TUNE_OPTIONS: tuple[str, ...] = (
    "kernels", "sigmas", "lams", "folds", "n_weight_samples", "weights",
    "dirichlet_alpha", "policy", "halving_eta", "sigma_continuation",
    "strategy", "rank", "max_iters", "tol", "seed", "warm_start", "precision",
    "telemetry",
)


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


def _solve_dist(problem: KRRProblem, method: str, mesh, kw: dict) -> SolveOutput:
    # imported lazily: the single-device path stays free of the distributed
    # stack, which itself imports repro_torch.core
    from repro_torch.distributed import krr_dist
    from repro_torch.serving.krr_serve import make_krr_predict_fn

    if method not in DIST_METHOD_OPTIONS:
        raise ValueError(
            f"method {method!r} has no distributed path; mesh= supports "
            f"{sorted(DIST_METHOD_OPTIONS)}"
        )
    unknown = sorted(set(kw) - set(DIST_METHOD_OPTIONS[method]))
    if unknown:
        raise ValueError(
            f"unknown option(s) {unknown} for method {method!r} with mesh=; "
            f"accepted: {sorted(DIST_METHOD_OPTIONS[method])}"
        )
    if method in ("askotch", "skotch"):
        res = krr_dist.solve_askotch_dist(
            problem, mesh, accelerated=(method == "askotch"), **kw
        )
    else:
        res = krr_dist.solve_pcg_dist(problem, mesh, precond=_PCG_PRECOND[method], **kw)
    return SolveOutput(
        method=method,
        w=res.w,
        history=res.history,
        info={"iters": res.iters, "converged": res.converged,
              "wall_time_s": res.wall_time_s, "mesh": dict(mesh.shape),
              **_head_info(problem, res.history)},
        predict_fn=make_krr_predict_fn(res.op, res.w),
    )


def _solve_dc(problem: KRRProblem, mesh, telemetry, kw: dict) -> SolveOutput:
    from repro_torch.distributed.dc import solve_dc  # lazy, as _solve_dist

    bad = sorted(k for k in kw if k.startswith("dc_") and k not in DC_METHOD_OPTIONS)
    if bad:
        raise ValueError(
            f"unknown option(s) {bad} for method 'dc'; accepted: "
            f"{sorted(DC_METHOD_OPTIONS)} plus the inner method's options "
            f"(METHOD_OPTIONS[dc_method])"
        )
    res = solve_dc(
        problem,
        shards=kw.pop("dc_shards", 2),
        partition=kw.pop("dc_partition", "random"),
        combiner=kw.pop("dc_combiner", "uniform"),
        method=kw.pop("dc_method", "askotch"),
        softmax_temp=kw.pop("dc_softmax_temp", None),
        mesh=mesh,
        telemetry=telemetry,
        **kw,
    )
    return SolveOutput(method="dc", w=res.w, history=res.history, info=res.info,
                       predict_fn=res.predict_fn)


def solve(problem: KRRProblem, method: str = "askotch", *, mesh=None, **kw) -> SolveOutput:
    """Solve (K + lam I) W = Y with any method the paper benchmarks.

    Args:
      problem: the :class:`~repro_torch.core.krr.KRRProblem`; ``problem.y``
        may be (n,) or (n, t) one-vs-all heads.
      method: one of :data:`METHODS`.
      mesh: optional :class:`~repro_torch.distributed.meshes.SolverMesh`;
        the methods of :data:`DIST_METHOD_OPTIONS` then run over a
        ``ShardedKernelOperator`` with W row-sharded (a (1, 1) mesh runs the
        distributed code with no collectives), and ``"dc"`` runs its shards
        on the mesh's devices.
      **kw: exactly :data:`METHOD_OPTIONS[method]`
        (:data:`DIST_METHOD_OPTIONS[method]` with ``mesh=``; ``"dc"`` takes
        :data:`DC_METHOD_OPTIONS` plus the inner method's options), plus the
        universal ``kernel=``, ``weights=`` and ``precision=`` overrides and
        ``telemetry=`` (a ``repro_torch.obs.Telemetry``: the method's span,
        trace events and tile-work metrics).

    Returns:
      A :class:`SolveOutput`: ``w`` ((n,), (n, t), or (m[, t]) for Falkon's
      inducing-point weights), the ``history`` records, an ``info`` dict and
      a ``predict_fn`` mapping (q, d) queries to (q[, t]) scores.
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
    if method == "dc":
        # the DC tier owns its mesh handling (explicit per-device placement,
        # zero collectives): routed before the sharded-operator dispatch
        return _solve_dc(problem, mesh, telemetry, kw)
    if mesh is not None:
        if problem.kernel == "precomputed":
            raise ValueError(
                "kernel='precomputed' cannot run over a mesh: the Gram "
                "matrix is a single-host array with no row-sharded kernel "
                "evaluation path — drop mesh= or pass the raw features with "
                "a kernel name"
            )
        tel = as_telemetry(telemetry)
        with tel.span(f"solve/dist-{method}", n=problem.n, t=problem.t,
                      mesh=dict(mesh.shape)):
            return _solve_dist(problem, method, mesh, kw)
    _validate_options(method, kw)
    if method in ("askotch", "skotch"):
        cfg_kw = {k: kw.pop(k) for k in _ASKOTCH_CFG_KEYS if k in kw}
        cfg = askotch.ASkotchConfig(accelerated=(method == "askotch"), **cfg_kw)
        res = askotch.solve(problem, cfg, telemetry=telemetry, **kw)
    elif method in _PCG_PRECOND:
        res = pcg.solve_pcg(problem, precond=_PCG_PRECOND[method], telemetry=telemetry, **kw)
    elif method == "falkon":
        res = falkon.solve_falkon(problem, telemetry=telemetry, **kw)
        return SolveOutput(
            method=method,
            w=res.w,
            history=res.history,
            info={"iters": res.iters, "wall_time_s": res.wall_time_s,
                  "m": res.w.shape[0], **_head_info(problem, res.history)},
            predict_fn=lambda xt: falkon.falkon_predict(problem, res, xt),
        )
    elif method == "eigenpro":
        res = eigenpro.solve_eigenpro(problem, telemetry=telemetry, **kw)
        return SolveOutput(
            method=method,
            w=res.w,
            history=res.history,
            info={"iters": res.iters, "wall_time_s": res.wall_time_s,
                  **_head_info(problem, res.history)},
            predict_fn=lambda xt: problem.predict(res.w, xt),
        )
    else:  # direct
        tel = as_telemetry(telemetry)
        with tel.span("solve/direct", n=problem.n, t=problem.t):
            w = direct.solve_direct(problem)
            if tel.enabled:  # the span covers the factorization's device work
                synchronize(problem.device)
        return SolveOutput(
            method=method,
            w=w,
            history=[],
            info=_head_info(problem, []),
            predict_fn=lambda xt: problem.predict(w, xt),
        )
    return SolveOutput(
        method=method,
        w=res.w,
        history=res.history,
        info={"iters": res.iters, "converged": res.converged,
              "wall_time_s": res.wall_time_s, **_head_info(problem, res.history)},
        predict_fn=lambda xt: problem.predict(res.w, xt),
    )


def tune(problem: KRRProblem, *, mesh=None, **kw):
    """Hyperparameter search over (sigma, lam) with k-fold CV — the
    policy-driven tile-sharing sweep of ``repro_torch.core.tune``.

    The search grows a WEIGHT axis when the problem is multi-kernel: pass
    ``kernels=("rbf", "laplacian", ...)`` (or a problem whose ``kernel`` is
    already a tuple) and it becomes a random search over convex kernel
    combinations (``repro_torch.core.tune.tune_multikernel``).

    Args:
      problem: data container (``x``/``y``/``kernel``/``precision`` used;
        ``sigma``/``lam_unscaled`` are the quantities being tuned).
      mesh: optional :class:`~repro_torch.distributed.meshes.SolverMesh`;
        candidates then run over the ``ShardedKernelOperator`` path, as
        ``solve(..., mesh=...)`` does.
      **kw: any of :data:`TUNE_OPTIONS` — or, on the multi-kernel path,
        :data:`MULTIKERNEL_TUNE_OPTIONS`; unknown options raise ValueError
        with the accepted list.  ``telemetry`` records the search span,
        per-group spans and the stacked solves' trace events.

    Returns:
      A :class:`repro_torch.core.tune.TuneResult`; refit with
      ``solve(apply_best(problem, result), method)``.
    """
    multikernel = (
        isinstance(problem.kernel, tuple)
        or any(k in kw for k in ("kernels", "n_weight_samples", "weights"))
    )
    accepted = MULTIKERNEL_TUNE_OPTIONS if multikernel else TUNE_OPTIONS
    unknown = sorted(set(kw) - set(accepted))
    if unknown:
        kind = "multi-kernel tune()" if multikernel else "tune()"
        raise ValueError(
            f"unknown option(s) {unknown} for {kind}; "
            f"accepted: {sorted(accepted)}"
        )
    if "precision" in kw:
        # universal precision override, mirroring solve(): the policy lives
        # on the problem and rides into every candidate operator
        problem = dataclasses.replace(
            problem, precision=check_precision(kw.pop("precision"))
        )
    if mesh is not None and problem.kernel == "precomputed":
        raise ValueError(
            "kernel='precomputed' cannot run over a mesh: the Gram matrix is "
            "a single-host array with no row-sharded kernel evaluation path — "
            "drop mesh= or pass the raw features with a kernel name"
        )
    from repro_torch.core.tune import tune as _tune
    from repro_torch.core.tune import tune_multikernel as _tune_multikernel

    if multikernel:
        return _tune_multikernel(problem, mesh=mesh, **kw)
    return _tune(problem, mesh=mesh, **kw)
