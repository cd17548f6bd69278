"""Train-step factory: loss -> gradients (with microbatch accumulation) ->
optimizer update — the port of ``repro.training.train_step``.

Gradients come from ``torch.autograd.grad`` over detached aliases of the
parameter leaves set to require grad (the caller's tensors keep their
flags; ``torch.func.grad`` composes badly with ``torch.utils.checkpoint``,
which the families use for remat).  A leaf the loss does not reach gets a
zero gradient, as ``jax.grad`` gives it.

Gradient accumulation: the batch splits into ``cfg.microbatches_train``
microbatches (clamped down to a divisor of the batch) run in order; each
microbatch's gradient is scaled by 1/m in its own dtype, cast to
``cfg.grad_accum_dtype`` and added in microbatch order, and the loss is the
microbatch mean, as the reference's ``lax.scan`` does.

``grad_compression="bf16"`` casts the gradients to bf16 before the update
(the reference's narrow cross-pod all-reduce; on one device only the
rounding remains).  The update writes the parameters and the optimizer state
in place; ``train_step`` returns them with ``{"loss", "grad_norm", "lr"}``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model_api import ArchConfig, _DTYPES, flatten, get_model, unflatten
from repro_torch.training.optimizers import Optimizer


def value_and_grad(loss_fn: Callable, params: dict, batch: dict, cfg: ArchConfig):
    """(loss, metrics, grads): ``loss_fn(params, batch, cfg)`` and its
    gradient tree (each leaf in its parameter's dtype)."""
    flat = flatten(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten(leaves), batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves.values(), grads)]
    return loss.detach(), metrics, unflatten(dict(zip(leaves, grads)))


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *, grad_compression: str = "none",
                    loss_fn: Callable | None = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``."""
    if grad_compression not in ("none", "bf16"):
        raise ValueError(f"grad_compression {grad_compression!r}: 'none' or 'bf16'")
    loss_fn = loss_fn or get_model(cfg).loss_fn
    m = max(int(cfg.microbatches_train), 1)
    acc_dt = _DTYPES[cfg.grad_accum_dtype]

    def _grads(params, batch):
        b0 = next(iter(batch.values())).shape[0]
        m_eff = m
        while b0 % m_eff != 0:  # clamp to what the batch divides into
            m_eff -= 1
        if m_eff == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch, cfg)
            return loss, metrics, grads
        micro = {k: v.chunk(m_eff) for k, v in batch.items()}
        acc, loss_sum = None, 0.0
        for i in range(m_eff):
            loss, _, grads = value_and_grad(loss_fn, params, {k: v[i] for k, v in micro.items()},
                                            cfg)
            flat = {k: (g * torch.tensor(1.0 / m_eff, dtype=g.dtype)).to(acc_dt)
                    for k, g in flatten(grads).items()}
            del grads
            if acc is None:
                acc = flat
            else:
                for k, g in flat.items():
                    acc[k].add_(g)
            loss_sum = loss_sum + loss
        loss = loss_sum / m_eff
        return loss, {"loss": loss}, unflatten(acc)

    def train_step(params, opt_state, batch, step):
        loss, _, grads = _grads(params, batch)
        if grad_compression == "bf16":
            grads = {k: g.to(torch.bfloat16) for k, g in flatten(grads).items()}
            grads = unflatten(grads)
        params, opt_state, opt_metrics = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step
