"""Decoder-only transformer LM — families "dense", "moe", "vlm"; the port of
``repro.models.transformer``.

Covers qwen2-1.5b, chatglm3-6b, command-r-plus-104b, llama3-405b (dense),
grok-1-314b, deepseek-moe-16b (MoE FFN), llava-next-mistral-7b (VLM: provided
patch embeddings prepended to the token sequence).

Structure: embedding -> a Python loop over L identical blocks (params
stacked on a leading L axis; the reference's ``lax.scan``) -> final norm ->
tied (or separate) LM head.  The reference's ``logical_constraint`` sharding
hints do nothing on one device and are dropped; its ``_remat`` policy wraps
each block when autograd records (``layers.remat``).

``decode_step`` writes the new token's K/V into the cache tensors in place
(the counterpart of the reference's donated cache): the returned cache holds
the same ``k`` / ``v`` tensors and ``pos + 1``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.model_api import (
    ArchConfig,
    ModelImpl,
    ParamDefs,
    ShapeConfig,
    cache_tensors,
    register_family,
    stacked,
)

TP = 16  # production tensor-parallel width (divisibility decisions)


def _attn_tp(cfg: ArchConfig) -> bool:
    return cfg.num_heads % TP == 0


def _expert_ep(cfg: ArchConfig) -> bool:
    return cfg.num_experts % TP == 0


# ----------------------------------------------------------------------------
# parameter table — single source of truth for shapes AND shardings
# ----------------------------------------------------------------------------


def param_defs(cfg: ArchConfig) -> ParamDefs:
    d, h, kv, hd, ff = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd, cfg.d_ff
    nl, vp = cfg.num_layers, cfg.padded_vocab(TP)
    atp = "tp" if _attn_tp(cfg) else None
    embed_spec = ("tp", "fsdp") if cfg.tie_embeddings else (None, "fsdp")
    defs: ParamDefs = {
        "embed": ((vp, d), embed_spec),
        "final_norm_scale": ((d,), (None,)),
    }
    if cfg.norm == "layernorm":
        defs["final_norm_bias"] = ((d,), (None,))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((vp, d), ("tp", None))

    lyr: ParamDefs = {
        "ln1_scale": ((nl, d), (None, None)),
        "wq": ((nl, d, h * hd), (None, "fsdp", atp)),
        "wk": ((nl, d, kv * hd), (None, "fsdp", None)),
        "wv": ((nl, d, kv * hd), (None, "fsdp", None)),
        "wo": ((nl, h * hd, d), (None, atp, "fsdp")),
        "ln2_scale": ((nl, d), (None, None)),
    }
    if cfg.norm == "layernorm":
        lyr["ln1_bias"] = ((nl, d), (None, None))
        lyr["ln2_bias"] = ((nl, d), (None, None))
    if cfg.qkv_bias:
        lyr["bq"] = ((nl, h * hd), (None, atp))
        lyr["bk"] = ((nl, kv * hd), (None, None))
        lyr["bv"] = ((nl, kv * hd), (None, None))

    if cfg.num_experts and cfg.moe_every == 1:
        lyr.update(_moe_defs(cfg, nl))
    elif cfg.num_experts:
        # mixed dense/MoE stacks are handled by the hybrid module
        raise ValueError("transformer family expects moe_every == 1")
    else:
        lyr.update(_mlp_defs(cfg, nl, ff))

    for k, v in lyr.items():
        defs[f"layers.{k}"] = v
    return defs


def _mlp_defs(cfg: ArchConfig, nl: int, ff: int, prefix: str = "") -> ParamDefs:
    d = cfg.d_model
    out: ParamDefs = {}
    if cfg.mlp_act == "swiglu":
        out[f"{prefix}w_gate"] = ((nl, d, ff), (None, "fsdp", "tp"))
        out[f"{prefix}w_up"] = ((nl, d, ff), (None, "fsdp", "tp"))
        out[f"{prefix}w_down"] = ((nl, ff, d), (None, "tp", "fsdp"))
    else:
        out[f"{prefix}w_up"] = ((nl, d, ff), (None, "fsdp", "tp"))
        out[f"{prefix}b_up"] = ((nl, ff), (None, "tp"))
        out[f"{prefix}w_down"] = ((nl, ff, d), (None, "tp", "fsdp"))
        out[f"{prefix}b_down"] = ((nl, d), (None, None))
    return out


def _moe_defs(cfg: ArchConfig, nl: int) -> ParamDefs:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    ep = _expert_ep(cfg)
    # EP: experts over "tp"; otherwise TP the expert ffn dim (grok 8e)
    cspec = (None, "tp", "fsdp", None) if ep else (None, None, "fsdp", "tp")
    rspec = (None, "tp", None, "fsdp") if ep else (None, None, "tp", "fsdp")
    out: ParamDefs = {
        "moe_router": ((nl, d, e), (None, "fsdp", None)),
        "moe_w_gate": ((nl, e, d, ff), cspec),
        "moe_w_up": ((nl, e, d, ff), cspec),
        "moe_w_down": ((nl, e, ff, d), rspec),
    }
    if cfg.num_shared_experts:
        sh_ff = cfg.num_shared_experts * ff
        out["moe_shared_w_gate"] = ((nl, d, sh_ff), (None, "fsdp", "tp"))
        out["moe_shared_w_up"] = ((nl, d, sh_ff), (None, "fsdp", "tp"))
        out["moe_shared_w_down"] = ((nl, sh_ff, d), (None, "tp", "fsdp"))
    return out


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------


def _ffn(cfg: ArchConfig, h: torch.Tensor, lp: dict) -> torch.Tensor:
    return L.moe_ffn(cfg, h, lp) if cfg.num_experts else L.mlp(cfg, h, lp)


def _block_prefill(cfg: ArchConfig, x, lp, positions):
    """One block over a full sequence; also returns its (k, v)."""
    h = L.apply_norm(cfg, x, lp, "ln1")
    q, k, v = L.qkv_project(cfg, h, lp)
    q = L.apply_rope(q, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    k = L.apply_rope(k, positions, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    attn = L.attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk)
    x = x + L.out_project(attn, lp)
    h = L.apply_norm(cfg, x, lp, "ln2")
    return x + _ffn(cfg, h, lp), k, v


def _block_decode(cfg: ArchConfig, x, lp, k_cache, v_cache, pos):
    """Single-token block against one layer's KV cache (written in place)."""
    h = L.apply_norm(cfg, x, lp, "ln1")
    q, k, v = L.qkv_project(cfg, h, lp)
    posb = torch.as_tensor(pos, device=x.device).expand(x.shape[0], 1)
    q = L.apply_rope(q, posb, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    k = L.apply_rope(k, posb, fraction=cfg.rope_fraction, theta=cfg.rope_theta)
    L.write_token(k_cache, pos, k)
    L.write_token(v_cache, pos, v)
    attn = L.decode_attention(q, k_cache, v_cache, pos + 1)
    x = x + L.out_project(attn, lp)
    h = L.apply_norm(cfg, x, lp, "ln2")
    return x + _ffn(cfg, h, lp)


# ----------------------------------------------------------------------------
# forward passes
# ----------------------------------------------------------------------------


def _embed_tokens(cfg: ArchConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.activation_dtype())


def _assemble_sequence(cfg, params, batch) -> torch.Tensor:
    """Token embeddings, with VLM prefix embeddings prepended if given."""
    x = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.num_prefix_tokens:
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    return x


def _trunk(cfg: ArchConfig, params: dict, x: torch.Tensor, collect_kv: bool = False):
    positions = torch.arange(x.shape[1], device=x.device)
    block = L.remat(cfg, functools.partial(_block_prefill, cfg))
    ks, vs = [], []
    for lp in stacked(params["layers"], cfg.num_layers):
        x, k, v = block(x, lp, positions)
        if collect_kv:
            ks.append(k.to(cfg.activation_dtype()))
            vs.append(v.to(cfg.activation_dtype()))
    return x, ks, vs


def _logits(cfg: ArchConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        x = L.layer_norm(x, params["final_norm_scale"], params["final_norm_bias"])
    else:
        x = L.rms_norm(x, params["final_norm_scale"])
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype).T


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """Mean next-token CE over positions with label >= 0."""
    x = _assemble_sequence(cfg, params, batch)
    x, _, _ = _trunk(cfg, params, x)
    loss, denom = L.lm_loss(_logits(cfg, params, x), batch["labels"])
    return loss, {"loss": loss, "tokens": denom}


def prefill(params: dict, batch: dict, cfg: ArchConfig):
    """Full-sequence forward building the KV cache; returns (logits, cache)."""
    x = _assemble_sequence(cfg, params, batch)
    x, ks, vs = _trunk(cfg, params, x, collect_kv=True)
    logits = _logits(cfg, params, x[:, -1:, :])
    cache = {
        "k": torch.stack(ks),  # (L, B, T, KV, hd)
        "v": torch.stack(vs),
        "pos": torch.tensor(x.shape[1], dtype=torch.int32, device=x.device),
    }
    return logits, cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig):
    """One new token per sequence against the cache.  batch: tokens (B, 1).
    The cache's k / v are written in place."""
    x = _embed_tokens(cfg, params, batch["tokens"])
    pos = cache["pos"]
    for layer, lp in enumerate(stacked(params["layers"], cfg.num_layers)):
        x = _block_decode(cfg, x, lp, cache["k"][layer], cache["v"][layer], pos)
    logits = _logits(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


# ----------------------------------------------------------------------------
# caches & input specs
# ----------------------------------------------------------------------------


def _cache_pspec() -> tuple:
    # (L, B, S, KV, hd): batch over dp, sequence over tp
    return (None, "dp", "tp", None, None)


def init_cache(cfg: ArchConfig, batch: int, seq: int, abstract: bool = False, *,
               device="cuda"):
    shape = (cfg.num_layers, batch, seq, cfg.kv_heads, cfg.hd)
    return cache_tensors({"k": shape, "v": shape}, cfg.activation_dtype(), seq, abstract,
                         device)


def cache_specs(cfg: ArchConfig, batch: int, seq: int):
    return {"k": _cache_pspec(), "v": _cache_pspec(), "pos": ()}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Meta-tensor stand-ins for every model input (dry-run contract)."""
    gb, t = shape.global_batch, shape.seq_len
    pfx = cfg.num_prefix_tokens
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": _meta((gb, t - pfx), i32), "labels": _meta((gb, t), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((gb, t - pfx), i32)}
    else:  # decode: one new token against a seq_len cache
        specs = {"tokens": _meta((gb, 1), i32)}
    if pfx and shape.kind != "decode":
        specs["prefix_embeds"] = _meta((gb, pfx, cfg.d_model), cfg.activation_dtype())
    return specs


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, tuple]:
    return {name: ("dp", None, None) if name == "prefix_embeds" else ("dp", None)
            for name in input_specs(cfg, shape)}


register_family(
    "transformer",
    ModelImpl(
        param_defs=param_defs,
        loss_fn=loss_fn,
        prefill=prefill,
        decode_step=decode_step,
        init_cache=init_cache,
        cache_specs=cache_specs,
        input_specs=input_specs,
    ),
)
