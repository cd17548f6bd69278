"""Deterministic synthetic data — the port of ``repro.data.synthetic``.

LM side: the reference's noisy arithmetic-progression token stream, VLM
prefix embeddings and audio frames, with the same shapes, dtypes and ``-1``
prefix labels, drawn from an explicit ``torch.Generator`` on the batch's
device (torch's streams, not JAX's: the tokens differ from the reference's
for the same seed).

KRR side: the numbers come from numpy, seeded exactly as in the reference,
so both packages build identical data from a seed; only the returned
container differs (tensors on ``device``, the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


# ----------------------------------------------------------------------------
# LM tokens
# ----------------------------------------------------------------------------


def lm_batch(generator: torch.Generator, batch: int, seq: int, vocab: int) -> dict:
    """{tokens, labels} int32 on the generator's device: a noisy arithmetic
    progression per sequence (start, stride in [1, 17), 5 % noise)."""
    dev = generator.device
    start = torch.randint(0, vocab, (batch, 1), generator=generator, device=dev)
    stride = torch.randint(1, 17, (batch, 1), generator=generator, device=dev)
    pos = torch.arange(seq + 1, device=dev)[None, :]
    clean = (start + stride * pos) % vocab
    noise_mask = torch.rand((batch, seq + 1), generator=generator, device=dev) < 0.05
    noise = torch.randint(0, vocab, (batch, seq + 1), generator=generator, device=dev)
    toks = torch.where(noise_mask, noise, clean).to(torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def vlm_batch(generator: torch.Generator, batch: int, seq: int, vocab: int, prefix: int,
              d_model: int, dtype=torch.bfloat16) -> dict:
    """``seq - prefix`` tokens, ``prefix`` patch embeddings (0.02 x normal)
    and labels of length ``seq`` whose first ``prefix`` entries are -1."""
    base = lm_batch(generator, batch, seq - prefix, vocab)
    emb = 0.02 * torch.randn((batch, prefix, d_model), generator=generator,
                             device=generator.device)
    labels = torch.cat([torch.full((batch, prefix), -1, dtype=torch.int32,
                                   device=generator.device), base["labels"]], dim=1)
    return {"tokens": base["tokens"], "labels": labels, "prefix_embeds": emb.to(dtype)}


def encdec_batch(generator: torch.Generator, batch: int, seq: int, vocab: int,
                 d_model: int, dtype=torch.bfloat16) -> dict:
    """Tokens, labels and ``seq`` audio frames (0.1 x normal)."""
    base = lm_batch(generator, batch, seq, vocab)
    frames = 0.1 * torch.randn((batch, seq, d_model), generator=generator,
                               device=generator.device)
    return {"frames": frames.to(dtype), "tokens": base["tokens"], "labels": base["labels"]}


def batch_for(cfg, shape_or_dims, seed: int, step: int, *, device="cuda") -> dict:
    """Family-aware synthetic batch on ``device``.  shape_or_dims: a
    ShapeConfig or (B, T); the generator is seeded from (seed, step)."""
    if hasattr(shape_or_dims, "global_batch"):
        b, t = shape_or_dims.global_batch, shape_or_dims.seq_len
    else:
        b, t = shape_or_dims
    gen = torch.Generator(device=resolve_device(device)).manual_seed(
        seed * 1_000_003 + step)
    dt = cfg.activation_dtype()
    if cfg.family == "encdec":
        return encdec_batch(gen, b, t, cfg.vocab_size, cfg.d_model, dt)
    if cfg.num_prefix_tokens:
        return vlm_batch(gen, b, t, cfg.vocab_size, cfg.num_prefix_tokens, cfg.d_model, dt)
    return lm_batch(gen, b, t, cfg.vocab_size)


# ----------------------------------------------------------------------------
# KRR datasets (paper-flavor)
# ----------------------------------------------------------------------------


def _to(device, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def krr_regression(seed: int, n: int, d: int, n_test: int = 0, noise: float = 0.1,
                   *, device="cuda"):
    """Smooth nonlinear target + Gaussian noise (molecule-dataset flavor).

    Returns (x_tr, y_tr, x_te, y_te)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + n_test, d)).astype(np.float32)
    w1 = rng.standard_normal((d,)).astype(np.float32) / np.sqrt(d)
    w2 = rng.standard_normal((d,)).astype(np.float32) / np.sqrt(d)
    f = np.sin(2.0 * (x @ w1)) + 0.5 * np.cos(x @ w2) + 0.2 * (x @ w1) ** 2
    y = (f + noise * rng.standard_normal(n + n_test)).astype(np.float32)
    return _to(device, x[:n], y[:n], x[n:], y[n:])


def krr_classification(seed: int, n: int, d: int, n_test: int = 0, *, device="cuda"):
    """Binary +-1 labels from a smooth score (covtype/susy flavor)."""
    x_tr, y_tr, x_te, y_te = krr_regression(seed, n, d, n_test, noise=0.05, device=device)
    return x_tr, torch.sign(y_tr), x_te, torch.sign(y_te)


def krr_one_vs_all(seed: int, n: int, d: int, num_classes: int = 4, n_test: int = 0,
                   *, device="cuda"):
    """Multi-class blobs encoded as (n, t) one-vs-all ±1 targets.

    Returns (x_tr, y_tr, labels_tr, x_te, y_te, labels_te)."""
    rng = np.random.default_rng(seed)
    m = n + n_test
    centers = rng.standard_normal((num_classes, d)).astype(np.float32) * 1.5
    labels = rng.integers(0, num_classes, size=m)
    x = centers[labels] + 0.6 * rng.standard_normal((m, d)).astype(np.float32)
    y = -np.ones((m, num_classes), np.float32)
    y[np.arange(m), labels] = 1.0
    lab = labels.astype(np.int32)
    return _to(device, x[:n], y[:n], lab[:n], x[n:], y[n:], lab[n:])


def taxi_like(seed: int, n: int, d: int = 9, *, device="cuda"):
    """Low-dimensional trip-feature blobs with heavy-tailed targets
    (taxi ride-duration flavor, §6.2).  Returns (x, y)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, size=(16, d)).astype(np.float32)
    assign = rng.integers(0, 16, size=n)
    x = centers[assign] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    base = np.linalg.norm(x[:, :2], axis=1) * 600.0
    y = base + 120.0 * rng.standard_normal(n) + 50.0 * np.abs(x[:, 2])
    return _to(device, x, y.astype(np.float32))
