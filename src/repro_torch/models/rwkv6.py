"""RWKV6 "Finch" (arXiv:2404.05892) — attention-free LM with data-dependent
per-channel decay; family "rwkv", the port of ``repro.models.rwkv6``.

Per layer: time-mix (the attention replacement) + channel-mix (the FFN
replacement).  Head dim 64; the recurrent state per head is a (64, 64)
matrix, so the decode "cache" is O(1) in sequence length.

Time-mix (heads H, head dim e):
    ddlerp token-shift mixing for r,k,v,w,g (base mu + low-rank data term)
    w_t = exp(-exp(decay(x)))            # data-dependent decay in (0,1)
    y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    out = W_o (GroupNorm_head(y) * silu(g))

The recurrence is a Python loop over time (the reference's ``lax.scan``).
A sequence of more than ``TIME_CHUNK`` steps (and a multiple of it) runs in
chunks, each rematerialized in the backward where autograd records, as the
reference's are: a backward would otherwise keep the (B, H, e, e) state of
every step.
Each block runs under ``cfg.remat`` (``layers.remat``).  ``decode_step``
writes the new states into the cache tensors in place.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

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

HEAD_DIM = 64
MIX_RANK = 32
DECAY_RANK = 64


def _heads(cfg: ArchConfig) -> int:
    return cfg.d_model // HEAD_DIM


def param_defs(cfg: ArchConfig) -> ParamDefs:
    d, ff, nl = cfg.d_model, cfg.d_ff, cfg.num_layers
    vp = cfg.padded_vocab()
    defs: ParamDefs = {
        "embed": ((vp, d), (None, "fsdp")),
        "lm_head": ((vp, d), ("tp", None)),
        "final_norm_scale": ((d,), (None,)),
    }
    lyr: ParamDefs = {
        "ln1_scale": ((nl, d), (None, None)),
        "ln2_scale": ((nl, d), (None, None)),
        # --- time mix -------------------------------------------------------
        "tm_maa_x": ((nl, d), (None, None)),
        "tm_maa": ((nl, 5, d), (None, None, None)),  # r,k,v,w,g bases
        "tm_mix_w1": ((nl, d, 5 * MIX_RANK), (None, "fsdp", None)),
        "tm_mix_w2": ((nl, 5, MIX_RANK, d), (None, None, None, None)),
        "tm_decay_base": ((nl, d), (None, "tp")),
        "tm_decay_w1": ((nl, d, DECAY_RANK), (None, "fsdp", None)),
        "tm_decay_w2": ((nl, DECAY_RANK, d), (None, None, "tp")),
        "tm_u": ((nl, d), (None, "tp")),  # per-channel bonus
        "tm_wr": ((nl, d, d), (None, "fsdp", "tp")),
        "tm_wk": ((nl, d, d), (None, "fsdp", "tp")),
        "tm_wv": ((nl, d, d), (None, "fsdp", "tp")),
        "tm_wg": ((nl, d, d), (None, "fsdp", "tp")),
        "tm_wo": ((nl, d, d), (None, "tp", "fsdp")),
        "tm_gn_scale": ((nl, d), (None, "tp")),
        "tm_gn_bias": ((nl, d), (None, "tp")),
        # --- channel mix ----------------------------------------------------
        "cm_mix_k": ((nl, d), (None, None)),
        "cm_mix_r": ((nl, d), (None, None)),
        "cm_wk": ((nl, d, ff), (None, "fsdp", "tp")),
        "cm_wv": ((nl, ff, d), (None, "tp", "fsdp")),
        "cm_wr": ((nl, d, d), (None, "fsdp", "tp")),
    }
    for k, v in lyr.items():
        defs[f"layers.{k}"] = v
    return defs


# ----------------------------------------------------------------------------
# time mix
# ----------------------------------------------------------------------------


def _ddlerp(x, xprev, lp):
    """Data-dependent token-shift mixing -> [xr, xk, xv, xw, xg]."""
    xx = xprev - x
    xxx = x + xx * lp["tm_maa_x"].to(x.dtype)
    b, t, d = x.shape
    lora = torch.tanh(xxx @ lp["tm_mix_w1"].to(x.dtype)).reshape(b, t, 5, MIX_RANK)
    deltas = torch.einsum("btfr,frd->btfd", lora, lp["tm_mix_w2"].to(x.dtype))
    mix = lp["tm_maa"].to(x.dtype)[None, None] + deltas  # (B,T,5,d)
    return [x + xx * mix[:, :, i] for i in range(5)]


def _decay(xw, lp):
    """w_t in (0,1): exp(-exp(base + low-rank(x)))."""
    low = torch.tanh(xw @ lp["tm_decay_w1"].to(xw.dtype)) @ lp["tm_decay_w2"].to(xw.dtype)
    logw = lp["tm_decay_base"].float() + low.float()
    return torch.exp(-torch.exp(torch.clamp(logw, -8.0, 4.0)))  # f32 (B,T,d)


def _group_norm(y, scale, bias, h):
    """Per-head layer norm of (B, T, H, e) flattened to d (population
    variance, eps 1e-5)."""
    b, t, _, e = y.shape
    y32 = y.float()
    mu = torch.mean(y32, dim=-1, keepdim=True)
    var = torch.var(y32, dim=-1, keepdim=True, unbiased=False)
    yn = ((y32 - mu) * torch.rsqrt(var + 1e-5)).reshape(b, t, h * e)
    return yn * scale.float() + bias.float()


TIME_CHUNK = 64  # remat granularity of the time scan (the reference's)


def _wkv_steps(r, k, v, w, u, s):
    ys = []
    for i in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, i], k[:, i], v[:, i], w[:, i]  # (B,H,e)
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B,H,e,e)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t, s + u[None, :, :, None] * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _wkv_scan(r, k, v, w, u, s0):
    """The RWKV6 recurrence.  r,k,v: (B,T,H,e); w: (B,T,H,e) decay in (0,1);
    u: (H,e); s0: (B,H,e,e).  Returns y (B,T,H,e), s_T."""
    t = r.shape[1]
    if t <= TIME_CHUNK or t % TIME_CHUNK != 0:
        return _wkv_steps(r, k, v, w, u, s0)
    s, ys = s0, []
    for c in range(0, t, TIME_CHUNK):
        part = slice(c, c + TIME_CHUNK)
        y, s = L.checkpointed(_wkv_steps, r[:, part], k[:, part], v[:, part], w[:, part], u, s)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _time_mix(cfg, x, xprev, lp, s0):
    b, t, d = x.shape
    h = _heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(x, xprev, lp)
    r = (xr @ lp["tm_wr"].to(x.dtype)).reshape(b, t, h, HEAD_DIM)
    k = (xk @ lp["tm_wk"].to(x.dtype)).reshape(b, t, h, HEAD_DIM)
    v = (xv @ lp["tm_wv"].to(x.dtype)).reshape(b, t, h, HEAD_DIM)
    g = F.silu(xg @ lp["tm_wg"].to(x.dtype))
    w = _decay(xw, lp).reshape(b, t, h, HEAD_DIM)
    u = lp["tm_u"].float().reshape(h, HEAD_DIM)
    y, s_t = _wkv_scan(r.float(), k.float(), v.float(), w, u, s0)
    y = _group_norm(y, lp["tm_gn_scale"], lp["tm_gn_bias"], h).to(x.dtype)
    return (y * g.reshape(b, t, d)) @ lp["tm_wo"].to(x.dtype), s_t


def _channel_mix(x, xprev, lp):
    xx = xprev - x
    xk = x + xx * lp["cm_mix_k"].to(x.dtype)
    xr = x + xx * lp["cm_mix_r"].to(x.dtype)
    kk = torch.square(F.relu(xk @ lp["cm_wk"].to(x.dtype)))
    vv = kk @ lp["cm_wv"].to(x.dtype)
    return torch.sigmoid(xr @ lp["cm_wr"].to(x.dtype)) * vv


def _shift(x: torch.Tensor, x0: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1}, with x0 (B, d) carried in from the cache."""
    first = torch.zeros_like(x[:, :1]) if x0 is None else x0[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _block(cfg, x, lp, s0, tm_x0=None, cm_x0=None):
    h = L.rms_norm(x, lp["ln1_scale"])
    tm_out, s_t = _time_mix(cfg, h, _shift(h, tm_x0), lp, s0)
    x = x + tm_out
    h2 = L.rms_norm(x, lp["ln2_scale"])
    x = x + _channel_mix(h2, _shift(h2, cm_x0), lp)
    # carry out the last normalized token for decode token-shift
    return x, s_t, h[:, -1], h2[:, -1]


def _embed(cfg, params, tokens):
    return params["embed"][tokens.long()].to(cfg.activation_dtype())


def _logits(cfg, params, x):
    x = L.rms_norm(x, params["final_norm_scale"])
    return x @ params["lm_head"].to(x.dtype).T


def _trunk(cfg, params, x):
    h = _heads(cfg)
    s0 = torch.zeros((x.shape[0], h, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                     device=x.device)
    block = L.remat(cfg, functools.partial(_block, cfg))
    states = []
    for lp in stacked(params["layers"], cfg.num_layers):
        x, s_t, tm_last, cm_last = block(x, lp, s0)
        states.append((s_t, tm_last, cm_last))
    return x, states


def loss_fn(params, batch, cfg):
    x = _embed(cfg, params, batch["tokens"])
    x, _ = _trunk(cfg, params, x)
    loss, _ = L.lm_loss(_logits(cfg, params, x), batch["labels"])
    return loss, {"loss": loss}


def prefill(params, batch, cfg):
    x = _embed(cfg, params, batch["tokens"])
    x, states = _trunk(cfg, params, x)
    s, tm_x, cm_x = (torch.stack(z) for z in zip(*states))
    cache = {
        "s": s,  # (L, B, H, e, e)
        "tm_x": tm_x,  # (L, B, d)
        "cm_x": cm_x,
        "pos": torch.tensor(x.shape[1], dtype=torch.int32, device=x.device),
    }
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(params, cache, batch, cfg):
    """One token; the cache's states are overwritten in place."""
    x = _embed(cfg, params, batch["tokens"])  # (B, 1, d)
    for i, lp in enumerate(stacked(params["layers"], cfg.num_layers)):
        x, s_t, tm_last, cm_last = _block(cfg, x, lp, cache["s"][i], cache["tm_x"][i],
                                          cache["cm_x"][i])
        cache["s"][i].copy_(s_t)
        cache["tm_x"][i].copy_(tm_last)
        cache["cm_x"][i].copy_(cm_last)
    return _logits(cfg, params, x), {"s": cache["s"], "tm_x": cache["tm_x"],
                                     "cm_x": cache["cm_x"], "pos": cache["pos"] + 1}


def init_cache(cfg: ArchConfig, batch: int, seq: int, abstract: bool = False, *,
               device="cuda"):
    """RWKV's 'KV cache of seq_len' is its O(1) recurrent state; seq only
    sets the starting position counter."""
    h, nl, d = _heads(cfg), cfg.num_layers, cfg.d_model
    shapes = {"s": (nl, batch, h, HEAD_DIM, HEAD_DIM), "tm_x": (nl, batch, d),
              "cm_x": (nl, batch, d)}
    act = cfg.activation_dtype()
    return cache_tensors(shapes, {"s": torch.float32, "tm_x": act, "cm_x": act}, seq,
                         abstract, device)


def cache_specs(cfg: ArchConfig, batch: int, seq: int):
    return {
        "s": (None, "dp", "tp", None, None),
        "tm_x": (None, "dp", None),
        "cm_x": (None, "dp", None),
        "pos": (),
    }


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    gb, t = shape.global_batch, shape.seq_len
    tokens = (gb, 1) if shape.kind == "decode" else (gb, t)
    specs = {"tokens": torch.empty(tokens, dtype=torch.int32, device="meta")}
    if shape.kind == "train":
        specs["labels"] = torch.empty((gb, t), dtype=torch.int32, device="meta")
    return specs


register_family(
    "rwkv",
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
