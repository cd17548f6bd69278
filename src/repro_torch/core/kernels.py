"""Kernel functions for KRR (paper §6 / Appendix C.1) plus the zoo extension.

The port of ``repro.core.kernels``: the same seven kernels, each
parameterized by ONE bandwidth ``sigma`` (a Python float):

  ========== ============================================
  rbf        exp(-||x-y||^2 / (2 sigma^2))
  laplacian  exp(-||x-y||_1 / sigma)
  matern52   (1 + s5 + 5 d^2/(3 sigma^2)) exp(-s5)
  linear     <x, y> / sigma^2
  polynomial (<x, y> / sigma^2 + 1)^3
  sigmoid    tanh(<x, y> / sigma^2 + 1)
  cosine     <x, y> / (||x|| ||y||)
  ========== ============================================

Each kernel belongs to a base-tile FAMILY (:data:`KERNEL_FAMILIES`): "l2"
(squared Euclidean), "l1" (Manhattan), "dot" (inner product), "cos"
(normalized inner product).  These materialising maps are the plain
versions; the CUDA kernels in ``csrc/`` compute the same formulas tile by
tile and are held against them.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

KERNEL_NAMES = (
    "rbf", "laplacian", "matern52", "linear", "polynomial", "sigmoid",
    "cosine",
)

#: base-tile family per kernel ("l2" squared-L2, "l1" Manhattan, "dot" inner
#: product, "cos" cosine similarity)
KERNEL_FAMILIES: dict[str, str] = {
    "rbf": "l2",
    "laplacian": "l1",
    "matern52": "l2",
    "linear": "dot",
    "polynomial": "dot",
    "sigmoid": "dot",
    "cosine": "cos",
}

#: kernels with k(x, x) = 1 for every x (tr K = n exactly)
UNIT_DIAG_KERNELS = ("rbf", "laplacian", "matern52", "cosine")

_SQRT5 = math.sqrt(5.0)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """At least f32: bf16 operands accumulate in f32, f64 stays f64."""
    return torch.promote_types(x.dtype, torch.float32)


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances via ||x||^2 + ||y||^2 - 2 <x, y>,
    clamped at 0."""
    dt = _acc_dtype(x)
    x, y = x.to(dt), y.to(dt)
    xx = (x * x).sum(-1)[:, None]
    yy = (y * y).sum(-1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)


def _l1_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 distances (O(m n d) memory: callers chunk)."""
    dt = _acc_dtype(x)
    x, y = x.to(dt), y.to(dt)
    return (x[:, None, :] - y[None, :, :]).abs().sum(-1)


def _dots(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise inner products <x_i, y_j>."""
    dt = _acc_dtype(x)
    return x.to(dt) @ y.to(dt).T


def _cos_sims(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarities; a zero row divides by 1 (sklearn's
    convention), so its similarities are exactly 0."""
    dt = _acc_dtype(x)
    x, y = x.to(dt), y.to(dt)
    xn = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    yn = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    x = x / torch.where(xn == 0.0, 1.0, xn)
    y = y / torch.where(yn == 0.0, 1.0, yn)
    return x @ y.T


def _apply_kernel(base: torch.Tensor, kernel: str, sigma: float) -> torch.Tensor:
    """Elementwise kernel map given the kernel family's base tile."""
    if kernel == "rbf":
        return torch.exp(-base / (2.0 * sigma**2))
    if kernel == "laplacian":
        return torch.exp(-base / sigma)
    if kernel == "matern52":
        d = torch.sqrt(base + 1e-20)
        s5 = _SQRT5 * d / sigma
        return (1.0 + s5 + 5.0 * base / (3.0 * sigma**2)) * torch.exp(-s5)
    if kernel == "linear":
        return base / sigma**2
    if kernel == "polynomial":
        return (base / sigma**2 + 1.0) ** 3
    if kernel == "sigmoid":
        return torch.tanh(base / sigma**2 + 1.0)
    if kernel == "cosine":
        return base
    raise ValueError(f"unknown kernel {kernel!r}; available: {KERNEL_NAMES}")


#: base-tile builder per family
_FAMILY_TILES: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "l2": _sq_dists,
    "l1": _l1_dists,
    "dot": _dots,
    "cos": _cos_sims,
}


def kernel_family(name: str) -> str:
    """Base-tile family of a kernel ("l2" | "l1" | "dot" | "cos")."""
    try:
        return KERNEL_FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; available: {KERNEL_NAMES}") from None


def kernel_matrix(name: str, x: torch.Tensor, y: torch.Tensor, sigma: float) -> torch.Tensor:
    """Materialize K(x, y).  Small operands only (tests, chunk tiles)."""
    return _apply_kernel(_FAMILY_TILES[kernel_family(name)](x, y), name, float(sigma))


def kernel_diag(name: str, x: torch.Tensor, sigma: float) -> torch.Tensor:
    """The (n,) f32 diagonal k(x_i, x_i) without forming K: unit for the
    shift-invariant kernels and cosine, ||x||^2-dependent for the
    dot-product family."""
    n = x.shape[0]
    if name in UNIT_DIAG_KERNELS:
        return torch.ones((n,), dtype=torch.float32, device=x.device)
    xf = x.to(_acc_dtype(x))
    sq = (xf * xf).sum(-1)
    s2 = float(sigma) ** 2
    if name == "linear":
        return (sq / s2).to(torch.float32)
    if name == "polynomial":
        return ((sq / s2 + 1.0) ** 3).to(torch.float32)
    if name == "sigmoid":
        return torch.tanh(sq / s2 + 1.0).to(torch.float32)
    raise ValueError(f"unknown kernel {name!r}; available: {KERNEL_NAMES}")
