"""Jamba-style hybrid (arXiv:2403.19887) — family "hybrid", the port of
``repro.models.hybrid``.

The stack is ``num_layers // attn_period`` PERIODS (a Python loop over the
stacked period axis); inside each period, ``attn_period`` sublayers run
unrolled — one attention sublayer (at the period midpoint, as in Jamba), the
rest Mamba — each followed by an FFN that alternates dense MLP / MoE.

Attention uses NO positional encoding (rope_fraction=0): the Mamba layers
carry position.  Prefill zeroes the Mamba decode states, as the reference
does on purpose (``repro.models.hybrid.prefill``); decode writes every state
and the new K/V into the cache tensors in place.  Each period runs under
``cfg.remat`` when autograd records (``layers.remat``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba
from repro_torch.models.model_api import (
    ArchConfig,
    ModelImpl,
    ParamDefs,
    cache_tensors,
    register_family,
    stacked,
)
from repro_torch.models.rwkv6 import input_specs


def _periods(cfg: ArchConfig) -> int:
    assert cfg.num_layers % cfg.attn_period == 0
    return cfg.num_layers // cfg.attn_period


def _attn_idx(cfg: ArchConfig) -> int:
    return cfg.attn_period // 2


def _n_moe(cfg: ArchConfig) -> int:
    return cfg.attn_period // cfg.moe_every


def _n_mlp(cfg: ArchConfig) -> int:
    return cfg.attn_period - _n_moe(cfg)


def param_defs(cfg: ArchConfig) -> ParamDefs:
    d, h, kv, hd, ff, e = (
        cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd, cfg.d_ff, cfg.num_experts,
    )
    pn, per = _periods(cfg), cfg.attn_period
    nm, nmoe, nmlp = per - 1, _n_moe(cfg), _n_mlp(cfg)
    vp = cfg.padded_vocab()
    defs: ParamDefs = {
        "embed": ((vp, d), (None, "fsdp")),
        "lm_head": ((vp, d), ("tp", None)),
        "final_norm_scale": ((d,), (None,)),
    }
    lyr: ParamDefs = {
        # attention sublayer (1 per period)
        "attn_ln_scale": ((pn, d), (None, None)),
        "wq": ((pn, d, h * hd), (None, "fsdp", "tp")),
        "wk": ((pn, d, kv * hd), (None, "fsdp", None)),
        "wv": ((pn, d, kv * hd), (None, "fsdp", None)),
        "wo": ((pn, h * hd, d), (None, "tp", "fsdp")),
        # mamba sublayers (per-1 per period)
        "mamba_ln_scale": ((pn, nm, d), (None, None, None)),
        # ffn sublayers
        "ffn_ln_scale": ((pn, per, d), (None, None, None)),
        "mlp_w_gate": ((pn, nmlp, d, ff), (None, None, "fsdp", "tp")),
        "mlp_w_up": ((pn, nmlp, d, ff), (None, None, "fsdp", "tp")),
        "mlp_w_down": ((pn, nmlp, ff, d), (None, None, "tp", "fsdp")),
        "moe_router": ((pn, nmoe, d, e), (None, None, "fsdp", None)),
        "moe_w_gate": ((pn, nmoe, e, d, ff), (None, None, "tp", "fsdp", None)),
        "moe_w_up": ((pn, nmoe, e, d, ff), (None, None, "tp", "fsdp", None)),
        "moe_w_down": ((pn, nmoe, e, ff, d), (None, None, "tp", None, "fsdp")),
    }
    for k, v in mamba.param_defs(cfg, (pn, nm)).items():
        lyr[f"mamba_{k}"] = v
    for k, v in lyr.items():
        defs[f"layers.{k}"] = v
    return defs


def _sub_params(pp: dict, prefix: str, idx: int) -> dict:
    """Slice the per-period stacked params for one sublayer instance."""
    plen = len(prefix)
    return {k[plen:]: v[idx] for k, v in pp.items() if k.startswith(prefix)}


def _is_moe(cfg: ArchConfig, j: int) -> bool:
    return j % cfg.moe_every == cfg.moe_every - 1


def _ffn(cfg: ArchConfig, x: torch.Tensor, pp: dict, j: int, mlp_i: int, moe_i: int):
    h = L.rms_norm(x, pp["ffn_ln_scale"][j])
    if _is_moe(cfg, j):
        p_moe = {k: pp[k][moe_i] for k in ("moe_router", "moe_w_gate", "moe_w_up",
                                            "moe_w_down")}
        return x + L.moe_ffn(cfg, h, p_moe)
    p_mlp = {k: pp[f"mlp_{k}"][mlp_i] for k in ("w_gate", "w_up", "w_down")}
    return x + L.mlp(cfg, h, p_mlp)


def _period(cfg: ArchConfig, x: torch.Tensor, pp: dict, attn_fn, mamba_fn):
    """One period of ``attn_period`` sublayers; ``attn_fn(h)`` and
    ``mamba_fn(h, mamba_i, p)`` return each mixer's output."""
    mlp_i = moe_i = mamba_i = 0
    for j in range(cfg.attn_period):
        if j == _attn_idx(cfg):
            x = x + attn_fn(L.rms_norm(x, pp["attn_ln_scale"]))
        else:
            h = L.rms_norm(x, pp["mamba_ln_scale"][mamba_i])
            x = x + mamba_fn(h, mamba_i, _sub_params(pp, "mamba_", mamba_i))
            mamba_i += 1
        x = _ffn(cfg, x, pp, j, mlp_i, moe_i)
        if _is_moe(cfg, j):
            moe_i += 1
        else:
            mlp_i += 1
    return x


def _period_train(cfg: ArchConfig, x: torch.Tensor, pp: dict):
    """One period over a full sequence; returns (x, (k, v) of its attention)."""
    kv_out = []

    def attn(h):
        q, k, v = L.qkv_project(cfg, h, pp)
        kv_out.append((k, v))
        return L.out_project(L.attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk), pp)

    x = _period(cfg, x, pp, attn, lambda h, i, mp: mamba.mamba_forward(cfg, h, mp)[0])
    return x, kv_out[0]


def _period_decode(cfg: ArchConfig, x, pp, kc, vc, hstates, bufs, pos):
    """One period, single token; kc / vc / hstates / bufs written in place."""

    def attn(h):
        q, k, v = L.qkv_project(cfg, h, pp)
        L.write_token(kc, pos, k)
        L.write_token(vc, pos, v)
        return L.out_project(L.decode_attention(q, kc, vc, pos + 1), pp)

    def mix(h, i, mp):
        out, (h_t, buf_t) = mamba.mamba_forward(cfg, h, mp, state=(hstates[i], bufs[i]))
        hstates[i].copy_(h_t)
        bufs[i].copy_(buf_t)
        return out

    return _period(cfg, x, pp, attn, mix)


def _embed(cfg, params, tokens):
    return params["embed"][tokens.long()].to(cfg.activation_dtype())


def _logits(cfg, params, x):
    x = L.rms_norm(x, params["final_norm_scale"])
    return x @ params["lm_head"].to(x.dtype).T


def _trunk(cfg, params, x):
    period = L.remat(cfg, functools.partial(_period_train, cfg))
    kvs = []
    for pp in stacked(params["layers"], _periods(cfg)):
        x, kv = period(x, pp)
        kvs.append(kv)
    return x, kvs


def loss_fn(params, batch, cfg):
    x, _ = _trunk(cfg, params, _embed(cfg, params, batch["tokens"]))
    loss, _ = L.lm_loss(_logits(cfg, params, x), batch["labels"])
    return loss, {"loss": loss}


def prefill(params, batch, cfg):
    x, kvs = _trunk(cfg, params, _embed(cfg, params, batch["tokens"]))
    # the Mamba decode states start zeroed, as in the reference's prefill
    cache = init_cache(cfg, x.shape[0], x.shape[1], device=x.device)
    cache["attn_k"].copy_(torch.stack([k for k, _ in kvs]))
    cache["attn_v"].copy_(torch.stack([v for _, v in kvs]))
    cache["pos"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(params, cache, batch, cfg):
    """Single-token decode; every cache tensor is written in place."""
    x = _embed(cfg, params, batch["tokens"])
    pos = cache["pos"]
    for i, pp in enumerate(stacked(params["layers"], _periods(cfg))):
        x = _period_decode(cfg, x, pp, cache["attn_k"][i], cache["attn_v"][i],
                           cache["mamba_h"][i], cache["mamba_buf"][i], pos)
    out = {k: cache[k] for k in ("attn_k", "attn_v", "mamba_h", "mamba_buf")}
    return _logits(cfg, params, x), {**out, "pos": pos + 1}


def init_cache(cfg: ArchConfig, batch: int, seq: int, abstract: bool = False, *,
               device="cuda"):
    pn, nm = _periods(cfg), cfg.attn_period - 1
    kv_shape = (pn, batch, seq, cfg.kv_heads, cfg.hd)
    (h_shape, h_dt), (b_shape, b_dt) = mamba.state_shapes(cfg, batch, (pn, nm))
    act = cfg.activation_dtype()
    return cache_tensors(
        {"attn_k": kv_shape, "attn_v": kv_shape, "mamba_h": h_shape, "mamba_buf": b_shape},
        {"attn_k": act, "attn_v": act, "mamba_h": h_dt, "mamba_buf": b_dt},
        seq, abstract, device)


def cache_specs(cfg: ArchConfig, batch: int, seq: int):
    kv = (None, "dp", "tp", None, None)
    h_spec, b_spec = mamba.state_specs(2)
    return {"attn_k": kv, "attn_v": kv, "mamba_h": h_spec, "mamba_buf": b_spec, "pos": ()}


register_family(
    "hybrid",
    ModelImpl(
        param_defs=param_defs,
        loss_fn=loss_fn,
        prefill=prefill,
        decode_step=decode_step,
        init_cache=init_cache,
        cache_specs=cache_specs,
        input_specs=input_specs,  # rwkv6's: the token-only families share it
    ),
)
