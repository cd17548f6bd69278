"""Whisper-style encoder-decoder (arXiv:2212.04356) — family "encdec", the
port of ``repro.models.encdec``.

The conv audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (B, T, d); sinusoidal positions are added on
the fly.  Encoder: bidirectional self-attention + GELU (tanh) MLP, pre-
LayerNorm.  Decoder: causal self-attention + cross-attention over the
encoder output + GELU MLP.  The decode step carries a self-attention KV
cache (written in place) plus the fixed cross K/V computed at prefill,
masked to ``cross_len``.  Whisper ties embedding and LM head.  Encoder and
decoder blocks run rematerialized when autograd records and ``cfg.remat``
is not "none" ("dots" saves nothing here either, as in the reference).
"""

from __future__ import annotations

import functools
import math
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


def param_defs(cfg: ArchConfig) -> ParamDefs:
    d, h, kv, hd, ff = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd, cfg.d_ff
    ne, nd = cfg.encoder_layers, cfg.num_layers
    vp = cfg.padded_vocab()
    atp = "tp" if h % 16 == 0 else None  # whisper-base: 8 heads -> replicated
    defs: ParamDefs = {
        "embed": ((vp, d), ("tp", "fsdp")),  # tied: used for both ends
        "enc_final_scale": ((d,), (None,)),
        "enc_final_bias": ((d,), (None,)),
        "dec_final_scale": ((d,), (None,)),
        "dec_final_bias": ((d,), (None,)),
    }

    def attn_defs(n):
        return {
            "ln1_scale": ((n, d), (None, None)),
            "ln1_bias": ((n, d), (None, None)),
            "wq": ((n, d, h * hd), (None, "fsdp", atp)),
            "wk": ((n, d, kv * hd), (None, "fsdp", None)),
            "wv": ((n, d, kv * hd), (None, "fsdp", None)),
            "wo": ((n, h * hd, d), (None, atp, "fsdp")),
        }

    def mlp_defs(n):
        return {
            "lnm_scale": ((n, d), (None, None)),
            "lnm_bias": ((n, d), (None, None)),
            "w_up": ((n, d, ff), (None, "fsdp", "tp")),
            "b_up": ((n, ff), (None, "tp")),
            "w_down": ((n, ff, d), (None, "tp", "fsdp")),
            "b_down": ((n, d), (None, None)),
        }

    for k, v in {**attn_defs(ne), **mlp_defs(ne)}.items():
        defs[f"encoder.{k}"] = v
    dec: ParamDefs = {
        **attn_defs(nd),  # self-attention
        "ln2_scale": ((nd, d), (None, None)),
        "ln2_bias": ((nd, d), (None, None)),
        "xwq": ((nd, d, h * hd), (None, "fsdp", atp)),
        "xwk": ((nd, d, kv * hd), (None, "fsdp", None)),
        "xwv": ((nd, d, kv * hd), (None, "fsdp", None)),
        "xwo": ((nd, h * hd, d), (None, atp, "fsdp")),
        **mlp_defs(nd),
    }
    for k, v in dec.items():
        defs[f"decoder.{k}"] = v
    return defs


def _inv_freq(d: int, device) -> torch.Tensor:
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    return torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))


def _sinusoid(t: int, d: int, dtype, device) -> torch.Tensor:
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid_at(pos: torch.Tensor, d: int, dtype) -> torch.Tensor:
    ang = pos.to(torch.float32) * _inv_freq(d, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _ln(x, lp, name):
    return L.layer_norm(x, lp[f"{name}_scale"], lp[f"{name}_bias"])


def _mlp(x, lp):
    hidden = L.gelu(x @ lp["w_up"].to(x.dtype) + lp["b_up"].to(x.dtype))
    return hidden @ lp["w_down"].to(x.dtype) + lp["b_down"].to(x.dtype)


def _project_heads(cfg, x, w, n_heads):
    b, t, _ = x.shape
    return (x @ w.to(x.dtype)).reshape(b, t, n_heads, cfg.hd)


def _self_attn(cfg, x, lp, causal):
    h = _ln(x, lp, "ln1")
    q = _project_heads(cfg, h, lp["wq"], cfg.num_heads)
    k = _project_heads(cfg, h, lp["wk"], cfg.kv_heads)
    v = _project_heads(cfg, h, lp["wv"], cfg.kv_heads)
    attn = L.attention(q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk)
    return x + L.out_project(attn, lp), (k, v)


def _cross_out(cfg, x, attn, lp):
    b, t = attn.shape[:2]
    return x + attn.reshape(b, t, cfg.num_heads * cfg.hd) @ lp["xwo"].to(x.dtype)


def _cross_attn(cfg, x, enc_k, enc_v, lp):
    q = _project_heads(cfg, _ln(x, lp, "ln2"), lp["xwq"], cfg.num_heads)
    attn = L.attention(q, enc_k, enc_v, causal=False, q_chunk=cfg.attn_q_chunk)
    return _cross_out(cfg, x, attn, lp)


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, d) precomputed frame embeddings (frontend stub)."""
    x = frames.to(cfg.activation_dtype())
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    block = L.remat(cfg, functools.partial(_enc_block, cfg), dots=False)
    for lp in stacked(params["encoder"], cfg.encoder_layers):
        x = block(x, lp)
    return L.layer_norm(x, params["enc_final_scale"], params["enc_final_bias"])


def _enc_block(cfg, x, lp):
    x, _ = _self_attn(cfg, x, lp, causal=False)
    return x + _mlp(_ln(x, lp, "lnm"), lp)


def _cross_kv(cfg, params, enc_out):
    """Per-decoder-layer cross K/V from the encoder output: (Ld, B, S, KV, hd) x2."""
    pairs = [(_project_heads(cfg, enc_out, lp["xwk"], cfg.kv_heads),
              _project_heads(cfg, enc_out, lp["xwv"], cfg.kv_heads))
             for lp in stacked(params["decoder"], cfg.num_layers)]
    return torch.stack([k for k, _ in pairs]), torch.stack([v for _, v in pairs])


def _dec_embed(cfg, params, tokens):
    x = params["embed"][tokens.long()].to(cfg.activation_dtype())
    return x + _sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]


def _dec_logits(params, x):
    x = L.layer_norm(x, params["dec_final_scale"], params["dec_final_bias"])
    return x @ params["embed"].to(x.dtype).T


def _decoder(cfg, params, x, xk, xv):
    """The decoder stack over a full sequence; returns (x, self K/V per layer)."""
    block = L.remat(cfg, functools.partial(_dec_block, cfg), dots=False)
    kvs = []
    for lp, ek, ev in zip(stacked(params["decoder"], cfg.num_layers), xk, xv):
        x, kv = block(x, lp, ek, ev)
        kvs.append(kv)
    return x, kvs


def _dec_block(cfg, x, lp, ek, ev):
    x, kv = _self_attn(cfg, x, lp, causal=True)
    x = _cross_attn(cfg, x, ek, ev, lp)
    return x + _mlp(_ln(x, lp, "lnm"), lp), kv


def decode_train(cfg, params, tokens, enc_out):
    xk, xv = _cross_kv(cfg, params, enc_out)
    x, _ = _decoder(cfg, params, _dec_embed(cfg, params, tokens), xk, xv)
    return _dec_logits(params, x)


def loss_fn(params, batch, cfg):
    enc_out = encode(cfg, params, batch["frames"])
    loss, _ = L.lm_loss(decode_train(cfg, params, batch["tokens"], enc_out), batch["labels"])
    return loss, {"loss": loss}


def prefill(params, batch, cfg):
    """Encode + decoder prefill over the given decoder tokens."""
    enc_out = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    xk, xv = _cross_kv(cfg, params, enc_out)
    x, kvs = _decoder(cfg, params, _dec_embed(cfg, params, tokens), xk, xv)
    dev = x.device
    cache = {
        "self_k": torch.stack([k for k, _ in kvs]),  # (Ld, B, T, KV, hd)
        "self_v": torch.stack([v for _, v in kvs]),
        "cross_k": xk, "cross_v": xv,  # (Ld, B, S, KV, hd)
        "cross_len": torch.tensor(enc_out.shape[1], dtype=torch.int32, device=dev),
        "pos": torch.tensor(tokens.shape[1], dtype=torch.int32, device=dev),
    }
    return _dec_logits(params, x[:, -1:]), cache


def decode_step(params, cache, batch, cfg):
    """One token; the self-attention cache is written in place."""
    pos, cross_len = cache["pos"], cache["cross_len"]
    x = params["embed"][batch["tokens"].long()].to(cfg.activation_dtype())
    x = x + _sinusoid_at(pos, cfg.d_model, x.dtype)[None, None, :]
    layers = stacked(params["decoder"], cfg.num_layers)
    for i, lp in enumerate(layers):
        kc, vc = cache["self_k"][i], cache["self_v"][i]
        h = _ln(x, lp, "ln1")
        q = _project_heads(cfg, h, lp["wq"], cfg.num_heads)
        L.write_token(kc, pos, _project_heads(cfg, h, lp["wk"], cfg.kv_heads))
        L.write_token(vc, pos, _project_heads(cfg, h, lp["wv"], cfg.kv_heads))
        x = x + L.out_project(L.decode_attention(q, kc, vc, pos + 1), lp)
        # cross attention with explicit length mask (cache may be padded)
        q2 = _project_heads(cfg, _ln(x, lp, "ln2"), lp["xwq"], cfg.num_heads)
        xattn = L.decode_attention(q2, cache["cross_k"][i], cache["cross_v"][i], cross_len)
        x = _cross_out(cfg, x, xattn, lp)
        x = x + _mlp(_ln(x, lp, "lnm"), lp)
    return _dec_logits(params, x), {**cache, "pos": pos + 1}


def init_cache(cfg: ArchConfig, batch: int, seq: int, abstract: bool = False, *,
               device="cuda"):
    shape = (cfg.num_layers, batch, seq, cfg.kv_heads, cfg.hd)
    out = cache_tensors({"self_k": shape, "self_v": shape, "cross_k": shape,
                         "cross_v": shape}, cfg.activation_dtype(), seq, abstract, device)
    # the reference's cross_len is seq (abstract: a scalar like pos)
    cross_len = out["pos"] if abstract else torch.full_like(out["pos"], seq)
    return {**{k: out[k] for k in ("self_k", "self_v", "cross_k", "cross_v")},
            "cross_len": cross_len, "pos": out["pos"]}


def cache_specs(cfg: ArchConfig, batch: int, seq: int):
    kv = (None, "dp", "tp", None, None)
    return {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv,
            "cross_len": (), "pos": ()}


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    gb, t = shape.global_batch, shape.seq_len

    def meta(s, dt=torch.int32):
        return torch.empty(s, dtype=dt, device="meta")

    frames = meta((gb, t, cfg.d_model), cfg.activation_dtype())
    if shape.kind == "train":
        return {"frames": frames, "tokens": meta((gb, t)), "labels": meta((gb, t))}
    if shape.kind == "prefill":
        return {"frames": frames, "tokens": meta((gb, t))}
    return {"tokens": meta((gb, 1))}


register_family(
    "encdec",
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
