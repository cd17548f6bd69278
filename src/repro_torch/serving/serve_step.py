"""Serving steps for the LM stack: prefill + batched single-token decode —
the port of ``repro.serving.serve_step``.

``make_serve_fns`` returns the (prefill, decode) closures over a config; the
decode closure writes the cache's tensors in place (the counterpart of the
reference's donated cache).  The reference's ``jit=`` option has no
counterpart in eager PyTorch and is dropped.  ``greedy_generate`` is the
batched temperature-0 driver the serving launcher uses.

KRR serving lives in ``repro_torch.serving.krr_serve`` and
``repro_torch.serving.engine``; ``make_krr_predict_fn`` is re-exported here
as the reference does.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.model_api import ArchConfig, get_model
from repro_torch.serving.krr_serve import make_krr_predict_fn  # noqa: F401  (re-export)


def make_serve_fns(cfg: ArchConfig):
    impl = get_model(cfg)

    def prefill(params, batch):
        return impl.prefill(params, batch, cfg)

    def decode(params, cache, tokens):
        return impl.decode_step(params, cache, {"tokens": tokens}, cfg)

    return prefill, decode


def greedy_generate(cfg: ArchConfig, params, batch: dict, max_new: int,
                    cache_len: int | None = None) -> torch.Tensor:
    """Prefill on ``batch``, then greedy-decode ``max_new`` tokens: (B,
    max_new) int32 on the batch's device."""
    impl = get_model(cfg)
    prefill, decode = make_serve_fns(cfg)
    logits, cache = prefill(params, batch)
    b = logits.shape[0]
    # cache["pos"] is the true prefill length (includes VLM prefixes)
    total = cache_len or (int(cache["pos"]) + max_new)
    # re-home the prefill cache into a cache sized for generation
    big = _copy_cache(cache, impl.init_cache(cfg, b, total, device=logits.device))
    out = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for _ in range(max_new):
        out.append(tok)
        logits, big = decode(params, big, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def _copy_cache(src: dict, dst: dict) -> dict:
    """``dst`` with ``src``'s entries: the same shape is taken as is (the
    scalar ``pos`` included), a tensor of rank >= 3 whose first two dims
    match fills the prefix of ``dst``'s along axis 2 (in place)."""
    out: dict[str, Any] = {}
    for k, v in dst.items():
        s = src.get(k)
        if s is None:
            out[k] = v
        elif s.shape == v.shape:
            out[k] = s
        elif s.ndim >= 3 and s.shape[:2] == v.shape[:2]:
            v[:, :, : s.shape[2]] = s.to(v.dtype)
            out[k] = v
        else:
            out[k] = s
    return out
