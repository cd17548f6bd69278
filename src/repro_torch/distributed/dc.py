"""Divide-and-conquer KRR: full local solves per shard, zero collectives —
the port of ``repro.distributed.dc``.

The communication-avoiding tier (DC-KRR / BKRR — You, Demmel, Hsieh &
Vuduc 2018).  :func:`solve_dc` partitions the training set into k shards
(``distributed.partition``), runs a complete, unmodified local solve per
shard through a plain per-shard operator — every ``solve()`` method, kernel
tuple and precision policy works unchanged — and combines the per-shard
predictions at query time.  The shards never exchange a byte during
iteration.  ``info["collective_dispatches"]`` is the measured
``repro_collective_dispatch_total`` delta across the solve (0).

Device parallelism: with ``mesh=``, shard s runs on mesh device ``s % D``
(its rows moved there), one host thread per distinct device running that
device's shards in shard order; each thread makes its device the current
CUDA device.  A mesh that repeats a device (the port's stand-in for more
devices) gives that device one thread, not one per entry: two host threads
solving on one CUDA device failed inside cuSOLVER (``geqrf``: internal
error) on an H100.  Without a mesh the shards run one after another on the
problem's device — the same results, keyed by shard index (any mesh on one
device gives bitwise the sequential run).

Combiners (``dc_combiner=``): ``"uniform"`` (weight 1/k per shard) and
``"softmax"`` (per-query weights ``softmax_s(-||x - c_s||^2 / (2 tau^2))``
over the partition centers; ``tau`` defaults to the mean pairwise center
distance).  Both give weights that sum to 1 per query; k = 1 returns the
single shard's prediction as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.partition import (
    PARTITION_KINDS,
    Partition,
    chunked_sq_dists,
    make_partition,
)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.telemetry import as_telemetry

#: accepted prediction combiners (the ``dc_combiner=`` vocabulary)
COMBINERS = ("uniform", "softmax")

_COLLECTIVE_METRIC = "repro_collective_dispatch_total"


def collective_dispatch_delta(before: dict[str, float], after: dict[str, float]) -> float:
    """Total ``repro_collective_dispatch_total`` growth between two metric
    :func:`repro_torch.obs.metrics.snapshot` dicts."""
    return sum(
        v for k, v in obs_metrics.diff(before, after).items()
        if k.startswith(_COLLECTIVE_METRIC)
    )


def combiner_weights(part: Partition, xq, combiner: str = "uniform",
                     softmax_temp: float | None = None) -> np.ndarray:
    """Per-query shard weights, a host (q, k) row-stochastic f32 array.

    ``"uniform"`` ignores the query values (every row is 1/k).
    ``"softmax"`` weights shard s by ``softmax_s(-||x - c_s||^2 / (2
    tau^2))`` with ``tau = softmax_temp`` (default: the mean pairwise
    distance between the partition centers).
    """
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}; accepted: {COMBINERS}")
    q, k = int(xq.shape[0]), part.k
    if combiner == "uniform" or k == 1:
        return np.full((q, k), 1.0 / k, np.float32)
    if softmax_temp is None:
        c2 = chunked_sq_dists(part.centers, part.centers)
        off = c2[~np.eye(k, dtype=bool)]
        softmax_temp = float(np.sqrt(np.maximum(off, 0.0)).mean()) or 1.0
    logits = -chunked_sq_dists(xq, part.centers) / (2.0 * float(softmax_temp) ** 2)
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


@dataclasses.dataclass
class DCSolveResult:
    """Everything :func:`solve_dc` produced: the partition, the per-shard
    ``SolveOutput``s and the combined ``predict_fn``.  ``w`` scatters the
    per-shard weights back to the original row order (None when the inner
    method's weights are not one per training row: Falkon)."""

    partition: Partition
    shard_outputs: list
    w: torch.Tensor | None
    predict_fn: Any
    info: dict[str, Any]
    history: list[dict]


def dc_predictor(part: Partition, shard_predict: list, combiner: str = "uniform",
                 softmax_temp: float | None = None, home="cpu", shard_devices=None):
    """The combined DC scorer over per-shard ``predict`` closures: queries
    go to each shard's device (``shard_devices``, default ``home``), the
    (q, k) :func:`combiner_weights` weigh the shard predictions, summed in
    shard order on ``home``.  k = 1 returns the one shard's prediction as
    it is."""
    k = len(shard_predict)
    home = torch.device(home)
    shard_devices = shard_devices or [home] * k

    def predict_fn(xt):
        if k == 1:  # exact single-shard degeneracy: the plain prediction
            return shard_predict[0](xt)
        wgt = torch.from_numpy(combiner_weights(part, xt, combiner, softmax_temp)).to(home)
        xt = torch.as_tensor(xt)
        preds = [fn(xt.to(dev)).to(home, torch.float32)
                 for fn, dev in zip(shard_predict, shard_devices)]
        extra = (1,) * (preds[0].ndim - 1)
        combined = 0
        for s in range(k):  # shard order: a fixed sum
            combined = combined + wgt[:, s].reshape((-1,) + extra) * preds[s]
        return combined

    return predict_fn


def _shard_problem(problem, idx: np.ndarray, device=None):
    take = torch.from_numpy(np.asarray(idx, np.int64)).to(problem.device)
    x, y = problem.x.index_select(0, take), problem.y.index_select(0, take)
    if device is not None:
        x, y = x.to(device), y.to(device)
    return dataclasses.replace(problem, x=x, y=y)


def _on_device(dev: torch.device | None):
    """Make ``dev`` the current CUDA device for the calling thread."""
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def solve_dc(
    problem,
    *,
    shards: int = 2,
    partition: str | Partition = "random",
    combiner: str = "uniform",
    method: str = "askotch",
    softmax_temp: float | None = None,
    mesh=None,
    telemetry=None,
    **kw,
) -> DCSolveResult:
    """Divide-and-conquer solve: k independent local solves, combined at
    query time, with zero collective traffic in between.

    Args:
      problem: the :class:`~repro_torch.core.krr.KRRProblem` (multi-RHS
        heads, kernel tuples and ``precision`` ride through unchanged).
      shards: shard count k (ignored when ``partition`` is a
        :class:`Partition`); k = 1 reproduces the plain solver bit-for-bit.
      partition: a ``PARTITION_KINDS`` name or a prebuilt :class:`Partition`
        (e.g. from ``Partition.from_json``, the JAX package's included).
      combiner: one of :data:`COMBINERS`.
      method: the INNER solver run per shard — any ``solve()`` method but
        ``"dc"``.
      softmax_temp: temperature for the softmax combiner.
      mesh: optional :class:`~repro_torch.distributed.meshes.SolverMesh`;
        shard s runs on device ``s % D`` (explicit placement, no
        collectives).
      telemetry: optional ``repro_torch.obs.Telemetry`` — a ``solve/dc``
        span around the tier and a ``dc/shard`` span per local solve.
      **kw: inner-method options, validated by the inner ``solve()``.

    Returns:
      A :class:`DCSolveResult`; ``info["collective_dispatches"]`` is the
      measured collective-dispatch delta (0.0).
    """
    from repro_torch.core.solver_api import METHODS, solve  # lazy: avoids a cycle

    if method == "dc" or method not in METHODS:
        inner = sorted(set(METHODS) - {"dc"})
        raise ValueError(
            f"dc_method {method!r} is not a valid inner solver; accepted: {inner}"
        )
    if problem.kernel == "precomputed":
        raise ValueError(
            "kernel='precomputed' cannot run through method='dc': a shard's "
            "subproblem re-slices raw features into a local KernelOperator — "
            "pass the features with a kernel name instead"
        )
    if isinstance(partition, Partition):
        part = partition
        if part.n != problem.n:
            raise ValueError(
                f"partition covers {part.n} rows but the problem has {problem.n}"
            )
    elif partition in PARTITION_KINDS:
        part = make_partition(problem.x, shards, kind=partition,
                              seed=int(kw.get("seed", 0) or 0))
    else:
        raise ValueError(
            f"unknown partition {partition!r}; accepted: {PARTITION_KINDS} "
            f"or a Partition instance"
        )
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}; accepted: {COMBINERS}")

    tel = as_telemetry(telemetry)
    shard_idx = part.shard_indices()
    k = part.k
    devices = list(mesh.devices.flat) if mesh is not None else [None]
    shard_dev = [devices[s % len(devices)] for s in range(k)]

    def run_shard(s: int):
        dev = shard_dev[s]
        with _on_device(dev):
            sub = _shard_problem(problem, shard_idx[s], dev)
            with tel.span("dc/shard", shard=s, n=sub.n, method=method):
                return solve(sub, method, telemetry=telemetry, **kw)

    def run_device(dev) -> dict:
        return {s: run_shard(s) for s in range(k) if shard_dev[s] == dev}

    before = obs_metrics.snapshot()
    t0 = time.perf_counter()
    with tel.span("solve/dc", n=problem.n, t=problem.t, shards=k,
                  partition=part.kind, combiner=combiner, method=method,
                  mesh=dict(mesh.shape) if mesh is not None else None):
        if mesh is not None and len(devices) > 1 and k > 1:
            # one host thread per distinct device drives its shards' local
            # solves in shard order
            owners = list(dict.fromkeys(shard_dev))
            done: dict = {}
            with ThreadPoolExecutor(max_workers=len(owners)) as pool:
                for part_done in pool.map(run_device, owners):
                    done.update(part_done)
            outputs = [done[s] for s in range(k)]
        else:
            outputs = [run_shard(s) for s in range(k)]
    wall = time.perf_counter() - t0
    collectives = collective_dispatch_delta(before, obs_metrics.snapshot())

    # scatter per-shard weights back to the original row order when the
    # inner method gives one weight per training row (all but Falkon)
    home = problem.device
    w_global = None
    if all(out.w.ndim >= 1 and out.w.shape[0] == len(idx)
           for out, idx in zip(outputs, shard_idx)):
        w_global = torch.zeros((problem.n,) + tuple(outputs[0].w.shape[1:]),
                               dtype=torch.float32, device=home)
        for out, idx in zip(outputs, shard_idx):
            w_global[torch.from_numpy(idx).to(home)] = out.w.to(home, torch.float32)

    predict_fn = dc_predictor(
        part, [out.predict_fn for out in outputs], combiner, softmax_temp, home,
        [dev or home for dev in shard_dev])

    per_shard_iters = [int(out.info.get("iters", 0)) for out in outputs]
    history: list[dict] = []
    for s, out in enumerate(outputs):
        rec = {"shard": s, "n": int(len(shard_idx[s])), "iters": per_shard_iters[s]}
        if out.history:
            rec["rel_residual"] = out.history[-1].get("rel_residual")
        history.append(rec)
    shard_rels = [r["rel_residual"] for r in history if r.get("rel_residual") is not None]
    # aggregate record last: history[-1]["rel_residual"] is the worst LOCAL
    # residual (krr_solve's summary line reads it)
    history.append({
        "shard": None, "iters": max(per_shard_iters, default=0),
        "rel_residual": max(shard_rels) if shard_rels else None,
    })
    info = {
        "shards": k,
        "partition": part.kind,
        "combiner": combiner,
        "inner_method": method,
        "per_shard_iters": per_shard_iters,
        "converged": all(bool(out.info.get("converged", True)) for out in outputs),
        "wall_time_s": wall,
        "collective_dispatches": collectives,
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "t": problem.t,
    }
    return DCSolveResult(partition=part, shard_outputs=outputs, w=w_global,
                         predict_fn=predict_fn, info=info, history=history)
