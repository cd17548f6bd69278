"""Optimizers over nested dicts of tensors: AdamW, Adafactor, SGD-momentum —
the port of ``repro.training.optimizers``.

Each is an :class:`Optimizer` of plain functions, as in the reference (not
``torch.optim``: its AdamW decays before the step, its Adafactor has
another beta and clipping rule, and its state layout is its own).  The
state trees use the reference's keys: ``{"m", "v"}`` for AdamW,
``{"m"}`` for SGD-momentum, and for Adafactor one dict per parameter,
``{"r", "c"}`` (row and column accumulators of a factored weight) or
``{"v"}``, so checkpoints cross between the two packages.

``update(grads, state, params, step)`` writes the parameters and the state
in place (under ``torch.no_grad``) and returns the same trees with
``{"grad_norm", "lr"}``; ``grads`` is read only.  The step's scalars (the
rate, the bias corrections, Adafactor's beta) are f32 0-d tensors computed
as the reference computes them; the arithmetic runs per parameter in f32.

Adafactor (Shazeer & Stern 2018) stores one (.., n) row and one (.., m)
column accumulator for a (.., n, m) weight.  A layer-stacked leaf (``ndim
>= 3`` and more than 4 layers) clips its update's RMS per layer slice, as
the reference's per-layer ``lax.map`` does; any other leaf over the whole.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.model_api import flatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any, dict]]  # (grads, state, params, step) -> ...
    state_specs: Callable[[Any, Any], Any]  # (param_spec_tree, param_struct) -> specs


def _rate(lr) -> Callable[[Any], torch.Tensor]:
    return lr if callable(lr) else (lambda step: torch.tensor(lr, dtype=torch.float32))


def _t(step) -> torch.Tensor:
    """step + 1 in f32 (the reference's ``step.astype(f32) + 1``)."""
    step = step if isinstance(step, torch.Tensor) else torch.tensor(step)
    return step.to(torch.float32) + 1.0


def _zeros_like(params: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def _at(tree: dict, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in f32."""
    leaves = list(flatten(tree).values()) if isinstance(tree, dict) else list(tree)
    sq = torch.stack([torch.sum(torch.square(g.float())) for g in leaves])
    return torch.sqrt(torch.sum(sq))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """(a new tree scaled so its global norm is at most ``max_norm``, the
    norm before clipping); each leaf scaled in its own dtype."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g * scale.to(g.dtype), tree), norm


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _decay_mask(path: str) -> bool:
    """True if weight decay applies: not to norms, biases or 1-d params,
    judged by the leaf name (the last dotted part of its path)."""
    name = path.rsplit(".", 1)[-1]
    return not any(s in name for s in ("scale", "bias", "b_", "ln"))


def _clipped(grads: dict, clip_norm: float):
    """(path -> f32 grad with the global clip folded in, one leaf at a time,
    the norm before clipping); no clip and a norm of 0 when ``clip_norm``
    is 0."""
    flat = flatten(grads)
    if not clip_norm:
        return ((k, g.float()) for k, g in flat.items()), torch.zeros((), dtype=torch.float32)
    norm = global_norm(list(flat.values()))
    scale = _clip_scale(norm, clip_norm)
    return ((k, (g * scale.to(g.dtype)).float()) for k, g in flat.items()), norm


def _write(p: torch.Tensor, u: torch.Tensor, lr_t: torch.Tensor) -> None:
    """p <- (p.f32 - lr_t * u) in p's dtype; ``u`` is consumed."""
    u.mul_(lr_t)
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(p.float().sub_(u))


# ----------------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------------


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, step, specs=None):
        del specs  # on one device the specs are data only
        flat_g, gnorm = _clipped(grads, clip_norm)
        t = _t(step)
        lr_t = lr_fn(step)
        bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
        for path, g32 in flat_g:
            p, m, v = _at(params, path), _at(state["m"], path), _at(state["v"], path)
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            u = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
            if weight_decay and _decay_mask(path):
                u.add_(p.float(), alpha=weight_decay)
            _write(p, u, lr_t)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    def state_specs(param_specs, _params_struct):
        return {"m": param_specs, "v": param_specs}

    return Optimizer(init=init, update=update, state_specs=state_specs)


# ----------------------------------------------------------------------------
# Adafactor
# ----------------------------------------------------------------------------


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _per_slice(p: torch.Tensor) -> bool:
    """A layer-stacked leaf: the reference updates it slice by slice."""
    return p.ndim >= 3 and p.shape[0] > 4


def adafactor(lr, *, decay: float = 0.99, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, clip_norm: float = 0.0) -> Optimizer:
    """``clip_norm`` 0 (the default) skips the global clip, as the
    reference does: the per-parameter RMS clip replaces it."""
    lr_fn = _rate(lr)

    def init(params):
        def leaf(p):
            if _factored(p):
                return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                         device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

        return _map(leaf, params)

    @torch.no_grad()
    def update(grads, state, params, step, specs=None):
        del specs
        flat_g, gnorm = _clipped(grads, clip_norm)
        lr_t = lr_fn(step)
        beta = torch.clamp(1.0 - _t(step) ** -0.8, max=decay)
        for path, g32 in flat_g:
            p, s = _at(params, path), _at(state, path)
            g2 = torch.square(g32).add_(eps)
            if _factored(p):
                r, c = s["r"], s["c"]
                r.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
                c.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))
                rmean = torch.mean(r, dim=-1, keepdim=True)
                vhat = (r / torch.clamp(rmean, min=eps))[..., None] * c[..., None, :]
            else:
                vhat = s["v"]
                vhat.mul_(beta).add_((1 - beta) * g2)
            del g2
            u = g32 / torch.sqrt(torch.clamp(vhat, min=eps))
            del vhat
            # RMS update clipping, per logical parameter (a layer slice of a
            # stacked leaf)
            dims = tuple(range(1, u.ndim)) if _per_slice(p) else tuple(range(u.ndim))
            rms = torch.sqrt(torch.mean(u * u, dim=dims, keepdim=True))
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            if weight_decay and _decay_mask(path):
                u.add_(p.float(), alpha=weight_decay)
            _write(p, u, lr_t)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    def state_specs(param_specs, params_struct):
        def leaf(spec, p):
            if _factored(p):
                entries = list(spec) + [None] * (p.ndim - len(spec))
                return {"r": tuple(entries[:-1]), "c": tuple(entries[:-2] + entries[-1:])}
            return {"v": spec}

        return {k: state_specs(v, params_struct[k]) if isinstance(v, dict)
                else leaf(v, params_struct[k]) for k, v in param_specs.items()}

    return Optimizer(init=init, update=update, state_specs=state_specs)


# ----------------------------------------------------------------------------
# SGD + momentum
# ----------------------------------------------------------------------------


def sgdm(lr, *, momentum: float = 0.9, weight_decay: float = 0.0,
         clip_norm: float = 1.0) -> Optimizer:
    lr_fn = _rate(lr)

    def init(params):
        return {"m": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, step, specs=None):
        del specs
        flat_g, gnorm = _clipped(grads, clip_norm)
        lr_t = lr_fn(step)
        for path, g32 in flat_g:
            p, m = _at(params, path), _at(state["m"], path)
            if weight_decay and _decay_mask(path):
                g32 = g32 + weight_decay * p.float()
            m.mul_(momentum).add_(g32)
            _write(p, m.clone(), lr_t)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    def state_specs(param_specs, _params_struct):
        return {"m": param_specs}

    return Optimizer(init=init, update=update, state_specs=state_specs)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgdm": sgdm}[name](lr, **kw)
