"""Deterministic synthetic KRR datasets — the port of the KRR generators of
``repro.data.synthetic``.

The numbers come from numpy, seeded exactly as in the reference, so both
packages build identical data from a seed; only the returned container
differs (tensors on ``device``, the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


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
