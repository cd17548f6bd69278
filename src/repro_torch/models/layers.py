"""Shared transformer building blocks (plain functions over param dicts) —
the port of ``repro.models.layers``.

Numerics policy, as in the reference: parameters stored in cfg.param_dtype,
computation in cfg.dtype (bf16 by default), softmax / norm statistics and
the attention products always in f32, residual stream in cfg.dtype.  Every
weight is cast to the activation dtype where it is used (``.to(x.dtype)``,
the reference's per-einsum ``astype``).  A bf16 product that the reference
asks for with ``preferred_element_type=f32`` runs on f32 copies of its bf16
inputs: each product is exact in f32 and the sum accumulates in f32.

Attention is q-chunked (exact): scores are materialized per (query chunk x
full key length) tile.  The reference's ``logical_constraint`` sharding
hints have no effect on one device and are dropped.

Remat.  Where autograd records (``recording``), the reference's
``jax.checkpoint`` sites become ``torch.utils.checkpoint`` (non-reentrant):
each attention query chunk and each MoE routing round when there are
several, and, through ``remat``, a family's block under ``cfg.remat``
("full" saves nothing, "dots" saves the outputs of products without batch
dims: ``aten.mm`` / ``aten.addmm``; the attention and expert products run
as ``bmm`` and are recomputed).  A forward that records nothing (serving)
runs the same ops without them.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models.model_api import ArchConfig

NEG_INF = -1e30  # masked scores (the reference's, not -inf)

# ----------------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------------


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def recording(*args) -> bool:
    """True when autograd records a use of any tensor in ``args`` (nested
    dicts, lists and tuples searched)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(args))


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of products
    without batch dims, recompute everything else."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn, *args, policy: str = "full"):
    """``fn(*args)``, rematerialized in the backward when autograd records
    it: ``policy`` "full" saves nothing inside ``fn``, "dots" the
    batch-free products."""
    if not recording(*args):
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)


def remat(cfg: ArchConfig, fn, *, dots: bool = True):
    """``fn`` under ``cfg.remat`` (the reference's per-family ``_remat``):
    as is for "none"; ``dots=False`` runs "dots" as "full" (encdec's
    choice)."""
    if cfg.remat == "none":
        return fn
    policy = "dots" if cfg.remat == "dots" and dots else "full"
    return functools.partial(checkpointed, fn, policy=policy)

# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if x.dtype == torch.float32:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * scale.to(x.dtype)
    # bf16 path: square in bf16, accumulate the mean in f32, cast the rsqrt
    # back to bf16 before the product (the reference's branch, kept bit for
    # bit in intent)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def apply_norm(cfg: ArchConfig, x: torch.Tensor, params: dict, prefix: str) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, params[f"{prefix}_scale"], params[f"{prefix}_bias"])
    return rms_norm(x, params[f"{prefix}_scale"])


# ----------------------------------------------------------------------------
# rotary embeddings (full or partial fraction — chatglm3 uses fraction=0.5)
# ----------------------------------------------------------------------------


def rope_frequencies(hd: int, fraction: float, theta: float, device=None) -> torch.Tensor:
    rot = int(hd * fraction) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, fraction: float,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, hd), positions: (B, T) or (T,).  Interleaved pairs
    (x[..., ::2], x[..., 1::2]) rotate, on the first ``rot`` dims only."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    freqs = rope_frequencies(hd, fraction, theta, x.device)  # (rot/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[:, :, None].to(torch.float32) * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # (B, T, 1, rot/2)
    sin = torch.sin(angles)[:, :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating groups (GQA -> MHA view)."""
    kv = k.shape[2]
    if kv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kv, dim=2)


def attention(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    causal: bool,
    q_offset: torch.Tensor | int = 0,  # absolute position of q[0]
    q_chunk: int = 512,
) -> torch.Tensor:
    """Exact attention, q-chunked.  Returns (B, T, H, hd) in q.dtype."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    k32 = repeat_kv(k, h).float()
    v = repeat_kv(v, h)
    v32 = v.float()
    scale = hd**-0.5
    kpos = torch.arange(s, device=q.device)

    def one_chunk(qc: torch.Tensor, start) -> torch.Tensor:
        scores = torch.einsum("bthd,bshd->bhts", qc.float(), k32) * scale  # (B, H, tc, S)
        if causal:
            qpos = start + torch.arange(qc.shape[1], device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v32)
        return out.to(q.dtype)

    if t <= q_chunk:
        return one_chunk(q, q_offset)
    assert t % q_chunk == 0, (t, q_chunk)
    # each chunk rematerialized: a backward would otherwise keep every
    # chunk's masks and probabilities
    return torch.cat([checkpointed(one_chunk, q[:, i:i + q_chunk], q_offset + i)
                      for i in range(0, t, q_chunk)], dim=1)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd) — filled up to `length`
    v_cache: torch.Tensor,
    length: torch.Tensor | int,  # valid prefix length (incl. current token)
) -> torch.Tensor:
    """Single-token attention against a KV cache, GQA-grouped: queries
    reshape to (B, KV, G, hd) and contract against the cache directly."""
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) * (hd**-0.5)
    mask = torch.arange(s, device=q.device)[None, None, None, :] < length
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def write_token(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at ``pos`` along
    axis 1, in place.  The start clamps to [0, S - 1] as
    ``lax.dynamic_update_slice_in_dim`` clamps it (a write at pos >= S lands
    on the last slot), and stays on the device: no host read of ``pos``."""
    idx = torch.as_tensor(pos, device=cache.device).clamp(0, cache.shape[1] - 1)
    cache.index_copy_(1, idx.reshape(1).long(), new.to(cache.dtype))


def qkv_project(cfg: ArchConfig, x: torch.Tensor, p: dict, prefix: str = ""):
    b, t, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    q = x @ p[f"{prefix}wq"].to(x.dtype)
    k = x @ p[f"{prefix}wk"].to(x.dtype)
    v = x @ p[f"{prefix}wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p[f"{prefix}bq"].to(x.dtype)
        k = k + p[f"{prefix}bk"].to(x.dtype)
        v = v + p[f"{prefix}bv"].to(x.dtype)
    return q.reshape(b, t, h, hd), k.reshape(b, t, kv, hd), v.reshape(b, t, kv, hd)


def out_project(x_attn: torch.Tensor, p: dict, prefix: str = "") -> torch.Tensor:
    b, t, h, hd = x_attn.shape
    return x_attn.reshape(b, t, h * hd) @ p[f"{prefix}wo"].to(x_attn.dtype)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (torch's default is
    the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def mlp(cfg: ArchConfig, x: torch.Tensor, p: dict, prefix: str = "") -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        gate = x @ p[f"{prefix}w_gate"].to(x.dtype)
        up = x @ p[f"{prefix}w_up"].to(x.dtype)
        hidden = F.silu(gate) * up
    else:  # gelu
        hidden = gelu(x @ p[f"{prefix}w_up"].to(x.dtype) + p[f"{prefix}b_up"].to(x.dtype))
    out = hidden @ p[f"{prefix}w_down"].to(x.dtype)
    if cfg.mlp_act != "swiglu":
        out = out + p[f"{prefix}b_down"].to(x.dtype)
    return out


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy (in f32) over positions with label >= 0,
    and the count of those positions (at least 1)."""
    logits = logits.float()
    labels = labels.long()
    mask = (labels >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    return torch.sum((logz - gold) * mask) / denom, denom


# ----------------------------------------------------------------------------
# Mixture of Experts — sort/gather "dropless-with-capacity" dispatch
# ----------------------------------------------------------------------------


def moe_route(xc: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k of softmax(xc @ router) in f32, the gates renormalised:
    (gates, experts), each (tokens, k)."""
    gates, experts = torch.topk(torch.softmax(xc.float() @ router, dim=-1), k, dim=-1)
    return gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9), experts


def moe_ffn(cfg: ArchConfig, x: torch.Tensor, p: dict, prefix: str = "moe_") -> torch.Tensor:
    """Top-k routed experts (+ optional always-on shared experts), the
    reference's gather dispatch: sort token assignments by expert (stable),
    rank within expert, drop beyond the static capacity C into a dummy slot
    E*C that is sliced off, gather into (E, C, d), run the expert FFNs as
    batched matmuls, scatter-add back weighted by the renormalised gates.
    Tokens route in chunks of at most ``moe_dispatch_tokens`` (halving)."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    n = b * t
    dev = x.device
    xf = x.reshape(n, d)

    nchunks = 1
    while n // nchunks > cfg.moe_dispatch_tokens and n % (nchunks * 2) == 0:
        nchunks *= 2
    chunk = n // nchunks

    cap = int(cfg.capacity_factor * chunk * k / e + 0.5)
    cap = max(8, -(-cap // 8) * 8)
    # combine accumulator: bf16 activations accumulate the <= top_k expert
    # contributions in bf16 (the reference's EP all-reduce saving); f32 exact
    if cfg.moe_combine_dtype == "float32" or x.dtype == torch.float32:
        acc_dt = torch.float32
    else:
        acc_dt = x.dtype
    router = p[f"{prefix}router"].float()
    w_up = p[f"{prefix}w_up"].to(x.dtype)
    w_down = p[f"{prefix}w_down"].to(x.dtype)
    w_gate = p[f"{prefix}w_gate"].to(x.dtype) if cfg.mlp_act == "swiglu" else None
    flat_tok = torch.arange(chunk, device=dev).repeat_interleave(k)
    experts_ids = torch.arange(e, device=dev)
    positions = torch.arange(chunk * k, device=dev)

    def route_chunk(xc: torch.Tensor) -> torch.Tensor:  # (chunk, d) -> (chunk, d)
        gates, experts = moe_route(xc, router, k)
        flat_exp = experts.reshape(-1)  # (chunk*k,)
        flat_gate = gates.reshape(-1)
        order = torch.argsort(flat_exp, stable=True)
        sorted_exp = flat_exp[order]
        group_start = torch.searchsorted(sorted_exp, experts_ids, side="left")
        rank = positions - group_start[sorted_exp]
        slot = torch.where(rank < cap, sorted_exp * cap + rank, e * cap)

        tok_for_slot = torch.full((e * cap + 1,), chunk, dtype=torch.long, device=dev)
        gate_for_slot = torch.zeros((e * cap + 1,), dtype=torch.float32, device=dev)
        tok_for_slot[slot] = flat_tok[order]
        gate_for_slot[slot] = flat_gate[order]
        tok_for_slot = tok_for_slot[: e * cap]
        gate_for_slot = gate_for_slot[: e * cap]

        xc_pad = torch.cat([xc, xc.new_zeros((1, d))], dim=0)
        xe = xc_pad[tok_for_slot].reshape(e, cap, d)
        if w_gate is not None:
            hid = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
        else:
            hid = gelu(torch.bmm(xe, w_up))
        ye = torch.bmm(hid, w_down).reshape(e * cap, d)

        out = torch.zeros((chunk + 1, d), dtype=acc_dt, device=dev)
        out.index_add_(0, tok_for_slot, ye.to(acc_dt) * gate_for_slot[:, None].to(acc_dt))
        return out[:chunk].to(xc.dtype)

    if nchunks == 1:
        out = route_chunk(xf)
    else:
        # each routing round rematerialized: a backward would otherwise keep
        # every round's (E*C, d) dispatch buffers
        out = torch.cat([checkpointed(route_chunk, xc)
                         for xc in xf.reshape(nchunks, chunk, d)], dim=0)

    if cfg.num_shared_experts:
        shared = mlp(cfg, x, p, prefix=f"{prefix}shared_")
        out = out + shared.reshape(n, d)
    return out.reshape(b, t, d)


def moe_aux_loss(router_logits: torch.Tensor, experts: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balancing loss (logged, weight configured upstream)."""
    probs = torch.softmax(router_logits, dim=-1)
    density = torch.mean(F.one_hot(experts[..., 0].long(), e).float(), dim=0)
    density_prob = torch.mean(probs, dim=0)
    return e * torch.sum(density * density_prob)
