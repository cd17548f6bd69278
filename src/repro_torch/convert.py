"""Carry a solved or tuned problem of the JAX package across to the port.

The reference hands over numpy arrays (``np.asarray(out.w)``), plain dicts
(``TuneResult.best``) and JSON (``Partition.to_json``); these helpers put
them on a device as the port's containers, so both packages predict, report
residuals and refit from the same weights, the same tuned model and the
same divide-and-conquer model; ``lm_params_from_reference`` carries an LM
parameter tree across by its dotted paths, and ``train_state_from_reference``
a training state (parameters and optimizer tree).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.askotch import SolverState
from repro_torch.core.krr import KRRProblem
from repro_torch.device import resolve_device


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=dev)  # a copy: JAX arrays are read-only


def _sigma(sigma):
    """One bandwidth as a float, or per-kernel bandwidths as a tuple of floats
    (``KRRProblem`` makes kernel lists tuples and weights floats itself)."""
    return tuple(float(s) for s in sigma) if isinstance(sigma, (list, tuple)) else float(sigma)


def from_reference(x, y, w, *, kernel="rbf", sigma=1.0, weights=None,
                   lam_unscaled: float = 1e-6, precision: str = "f32",
                   device="cuda") -> tuple[KRRProblem, torch.Tensor]:
    """The port's :class:`KRRProblem` over the reference's (x, y) and its
    solved weights ``w`` as a tensor, both on ``device``.  ``kernel`` may be
    a tuple of names (a weighted-sum problem) with per-kernel ``sigma`` and
    combination ``weights``."""
    dev = resolve_device(device)
    problem = KRRProblem(
        x=_tensor(x, dev), y=_tensor(y, dev), kernel=kernel, sigma=_sigma(sigma),
        weights=weights, lam_unscaled=float(lam_unscaled), precision=precision,
    )
    return problem, _tensor(w, dev)


def problem_from_best(x, y, best: dict, *, device="cuda") -> KRRProblem:
    """The port's :class:`KRRProblem` for a tuned model: the reference's
    ``TuneResult.best`` dict (kernel or kernel list, sigma or per-kernel
    sigmas, ``weights`` for a multi-kernel search, ``lam_unscaled``,
    ``precision``) over (x, y) on ``device``."""
    dev = resolve_device(device)
    return KRRProblem(
        x=_tensor(x, dev), y=_tensor(y, dev), kernel=best["kernel"], sigma=_sigma(best["sigma"]),
        weights=best.get("weights"), lam_unscaled=float(best["lam_unscaled"]),
        precision=best.get("precision", "f32"),
    )


def state_from_reference(w, v, z, it, *, seed: int = 0, device="cuda") -> SolverState:
    """A port :class:`SolverState` from a reference ``SolverState``'s
    (w, v, z, it) arrays; the port's draws come from a fresh generator
    seeded with ``seed`` (JAX keys do not carry across)."""
    dev = resolve_device(device)
    w_t = _tensor(w, dev)
    return SolverState(
        w=w_t, v=_tensor(v, dev), z=_tensor(z, dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        it=int(np.asarray(it)),
        sketch_res=torch.full(() if w_t.ndim == 1 else (w_t.shape[1],), float("inf"),
                              dtype=torch.float32, device=dev),
    )


def partition_from_reference(part):
    """The port's :class:`~repro_torch.distributed.partition.Partition` from
    the reference's (or from its ``to_json()`` string): the one format both
    packages read."""
    from repro_torch.distributed.partition import Partition

    return Partition.from_json(part if isinstance(part, str) else part.to_json())


def dc_from_reference(x, part, shard_ws, *, kernel="rbf", sigma=1.0, weights=None,
                      precision: str = "f32", combiner: str = "uniform",
                      softmax_temp: float | None = None, device="cuda"):
    """A reference DC model as the port's: ``(partition, w, predict_fn)``.

    ``x``: the (n, d) training rows; ``part``: the reference's partition
    (or its JSON); ``shard_ws``: each shard's weights as numpy
    (``[np.asarray(o.w) for o in result.shard_outputs]``, one weight per
    shard row).  ``w`` is the (n[, t]) scatter back to row order and
    ``predict_fn`` the port's combiner over the shards' kernel sweeps on
    ``device``."""
    from repro_torch.core.multikernel import make_operator
    from repro_torch.distributed.dc import dc_predictor

    dev = resolve_device(device)
    partition = partition_from_reference(part)
    x_t = _tensor(np.asarray(x, np.float32), dev)
    ws = [_tensor(np.asarray(w, np.float32), dev) for w in shard_ws]
    w = torch.zeros((partition.n,) + tuple(ws[0].shape[1:]), dtype=torch.float32, device=dev)
    shard_predict = []
    for idx, w_s in zip(partition.shard_indices(), ws):
        take = torch.from_numpy(idx).to(dev)
        w[take] = w_s
        op = make_operator(x_t.index_select(0, take), kernel=kernel, sigma=_sigma(sigma),
                           weights=weights, precision=precision)
        shard_predict.append(lambda xt, op=op, w_s=w_s: op.row_block_matvec(
            torch.as_tensor(xt).to(dev), w_s))
    return partition, w, dc_predictor(partition, shard_predict, combiner, softmax_temp, dev)


def _leaf_tensor(a) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (numpy's ``ml_dtypes`` type, which
    torch cannot read directly) goes across as its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a copy: JAX arrays are read-only


def lm_params_from_reference(params: dict, cfg, *, device="cuda") -> dict:
    """The JAX package's LM parameter tree (nested dicts of numpy arrays,
    ``jax.tree.map(np.asarray, params)``) as the port's: every dotted path
    and shape kept, each leaf on ``device`` in ``cfg``'s parameter dtype.
    Raises ``ValueError`` on a path missing from or extra to the config's
    ``param_defs``, or on a shape that differs."""
    from repro_torch.models.model_api import flatten, get_model, unflatten

    dev = resolve_device(device)
    defs = get_model(cfg).param_defs(cfg)
    flat = flatten(params)
    missing, extra = sorted(set(defs) - set(flat)), sorted(set(flat) - set(defs))
    if missing or extra:
        raise ValueError(f"{cfg.name}: paths missing {missing}, extra {extra}")
    bad = {p: (tuple(np.shape(flat[p])), shape) for p, (shape, _) in defs.items()
           if tuple(np.shape(flat[p])) != tuple(shape)}
    if bad:
        raise ValueError(f"{cfg.name}: shapes (got, want) {bad}")
    dtype = cfg.parameter_dtype()
    return unflatten({p: _leaf_tensor(flat[p]).to(device=dev, dtype=dtype) for p in defs})


def train_state_from_reference(params: dict, opt_state: dict, cfg, optimizer_name: str, *,
                               device="cuda") -> tuple[dict, dict]:
    """The JAX package's training state (its parameter tree and the state
    tree of its ``optimizer_name`` optimizer, as numpy:
    ``jax.tree.map(np.asarray, ...)``) as the port's ``(params,
    opt_state)`` on ``device``: parameters as ``lm_params_from_reference``
    gives them, each optimizer leaf in its own dtype (bf16 through its
    bits).  Raises ``ValueError`` where the optimizer tree's paths or shapes
    differ from what the port's optimizer would hold for ``cfg``."""
    from repro_torch.models.model_api import abstract_params, flatten, unflatten
    from repro_torch.training.optimizers import make_optimizer

    dev = resolve_device(device)
    want = flatten(make_optimizer(optimizer_name, 0.0).init(abstract_params(cfg)))
    flat = flatten(opt_state)
    if sorted(flat) != sorted(want):
        raise ValueError(f"{cfg.name} {optimizer_name}: state paths missing "
                         f"{sorted(set(want) - set(flat))}, extra {sorted(set(flat) - set(want))}")
    bad = {p: (tuple(np.shape(flat[p])), tuple(t.shape)) for p, t in want.items()
           if tuple(np.shape(flat[p])) != tuple(t.shape)}
    if bad:
        raise ValueError(f"{cfg.name} {optimizer_name}: state shapes (got, want) {bad}")
    state = unflatten({p: _leaf_tensor(flat[p]).to(dev) for p in want})
    return lm_params_from_reference(params, cfg, device=dev), state
