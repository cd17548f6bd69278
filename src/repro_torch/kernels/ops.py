"""Dispatch for the fused kernel ops, by the tensor's device.

A CPU tensor runs the plain PyTorch version (``ref``); a CUDA tensor
launches the hand-written CUDA kernel (``kernel_matvec``, ``kernel_block``,
and the three multi-kernel ops of ``multi``), which raises on what it does
not take.  There is no fallback from one to the other.  ``meta`` operands
(the dry run: shapes, no data) compute nothing: they get an empty result
of the kernel's shape and add the kernel's analytic FLOPs and bytes to the
active cost counter (``repro_torch.roofline.analyze``), which no dispatch
mode would see through the CUDA kernels' ctypes calls.  Operands on mixed
devices raise.

Every entry point shares the contract of ``repro.kernels.ops``: never form
K(a, b) beyond one tile, accumulate in f32, accept a multi-RHS value matrix
(an ``(n, t)`` v rides the same kernel tiles as an ``(n,)`` v), take
``precision="f32"|"bf16"``, and cast ``sigma`` once, here, to a Python float
(a tuple of floats for the multi-kernel ops).

Solvers do not call these directly; they go through
``repro_torch.core.operator.KernelOperator``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.core.kernels import kernel_family
from repro_torch.kernels import ref
from repro_torch.kernels.kernel_block import kernel_block_cuda
from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda
from repro_torch.kernels.multi import (
    kernel_block_multi_cuda,
    kernel_matvec_components_cuda,
    kernel_matvec_multi_cuda,
)
from repro_torch.kernels.precision import PRECISIONS, check_precision
from repro_torch.roofline import analyze

__all__ = [
    "PRECISIONS", "check_precision", "kernel_matvec", "kernel_block", "kernel_matvec_multi",
    "kernel_matvec_components", "kernel_block_multi", "reset_launches", "launches",
]

#: every CUDA kernel wrapper, by the name its launch count is reported under
_WRAPPERS = {
    "kernel_matvec": kernel_matvec_cuda,
    "kernel_block": kernel_block_cuda,
    "kernel_matvec_multi": kernel_matvec_multi_cuda,
    "kernel_matvec_components": kernel_matvec_components_cuda,
    "kernel_block_multi": kernel_block_multi_cuda,
}


def _route(*xs: torch.Tensor) -> str:
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"meta"}:
        return "meta"
    raise ValueError(f"operands must all be on the CPU, all on CUDA or all on meta; "
                     f"got {sorted(kinds)}")


def _meta_result(name: str, shape: tuple[int, ...], cost: tuple[float, float]
                 ) -> torch.Tensor:
    """The kernel's f32 result on meta, its analytic work recorded."""
    analyze.record_kernel(name, *cost)
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _dims(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor | None = None):
    """(m, n, d, t) of an op on (m, d) x (n, d) rows and a value matrix."""
    t = None if v is None else (1 if v.ndim == 1 else v.shape[1])
    return a.shape[0], b.shape[0], a.shape[1], t


def kernel_matvec(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    *,
    kernel: str = "rbf",
    sigma: float = 1.0,
    chunk_a: int = 4096,
    chunk_b: int = 8192,
    precision: str = "f32",
) -> torch.Tensor:
    """out = K(a, b) @ v without materializing K.

    v: (n,) -> (m,) or (n, t) -> (m, t); all t columns share the kernel tiles.
    ``chunk_a``/``chunk_b`` size the plain version's chunk pairs (CPU).
    """
    precision = check_precision(precision)
    kernel_family(kernel)  # unknown kernel names raise here
    sigma = float(sigma)
    route = _route(a, b, v)
    if route == "meta":
        m, n, d, t = _dims(a, b, v)
        return _meta_result("kernel_matvec", (m,) + tuple(v.shape[1:]),
                            analyze.kernel_cost(m, n, d, t, kernel))
    if route == "cpu":
        return ref.kernel_matvec(
            a, b, v, sigma, kernel=kernel, chunk_a=chunk_a, chunk_b=chunk_b,
            precision=precision,
        )
    return kernel_matvec_cuda(a, b, v, kernel=kernel, sigma=sigma, precision=precision)


def kernel_block(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    kernel: str = "rbf",
    sigma: float = 1.0,
    precision: str = "f32",
) -> torch.Tensor:
    """Materialize K(a, b) (m, n) f32 (use for small/medium blocks only)."""
    precision = check_precision(precision)
    kernel_family(kernel)
    sigma = float(sigma)
    route = _route(a, b)
    if route == "meta":
        m, n, d, _ = _dims(a, b)
        return _meta_result("kernel_block", (m, n), analyze.kernel_cost(m, n, d, None, kernel))
    if route == "cpu":
        return ref.kernel_block(a, b, sigma, kernel=kernel, precision=precision)
    return kernel_block_cuda(a, b, kernel=kernel, sigma=sigma, precision=precision)


# ---------------------------------------------------------------------------
# multi-kernel entry points — same contract, q kernels per data sweep.
# ``kernels``/``sigmas`` are per-kernel tuples; ``weights`` is q floats for
# a fixed weighted-sum operator or a (q, t) tensor of per-column weight
# vectors (the multi-kernel tuning engine).
# ---------------------------------------------------------------------------


def _multi_spec(kernels, sigmas, precision):
    precision = check_precision(precision)
    kernels = tuple(kernels)
    for k in kernels:
        kernel_family(k)  # unknown kernel names raise here
    sigmas = tuple(float(s) for s in sigmas)
    if len(sigmas) != len(kernels):
        raise ValueError(f"{len(sigmas)} sigmas for {len(kernels)} kernels")
    return kernels, sigmas, precision


def kernel_matvec_multi(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    *,
    kernels: tuple[str, ...],
    sigmas: tuple[float, ...],
    weights,
    chunk_a: int = 4096,
    chunk_b: int = 8192,
    precision: str = "f32",
) -> torch.Tensor:
    """out = (sum_i w_i K_i(a, b)) @ v without materializing any K_i.

    v: (n,) -> (m,) or (n, t) -> (m, t); ``weights``: a sequence of q floats
    (the fixed weighted-sum operator; it reaches the CUDA kernel by value)
    or a (q, t) tensor on the operands' device (one weight vector per
    column: the multi-kernel tuning engine).
    """
    kernels, sigmas, precision = _multi_spec(kernels, sigmas, precision)
    q = len(kernels)
    if isinstance(weights, torch.Tensor):
        if weights.ndim != 2 or weights.shape[0] != q:
            raise ValueError(f"per-column weights must be a ({q}, t) tensor; "
                             f"got {tuple(weights.shape)}")
        operands, w_plain = (a, b, v, weights), weights
    elif isinstance(weights, Sequence):
        weights = tuple(float(x) for x in weights)
        if len(weights) != q:
            raise ValueError(f"{len(weights)} weights for {q} kernels")
        operands, w_plain = (a, b, v), None
    else:
        raise TypeError(f"weights must be a sequence of {q} floats or a ({q}, t) tensor; "
                        f"got {type(weights).__name__}")
    route = _route(*operands)
    if route == "meta":
        m, n, d, t = _dims(a, b, v)
        kind = "matvec" if w_plain is None else "cols"
        return _meta_result("kernel_matvec_multi", (m,) + tuple(v.shape[1:]),
                            analyze.multi_kernel_cost(m, n, d, t, kernels, kind))
    if route == "cpu":
        if w_plain is None:
            w_plain = torch.tensor(weights, dtype=torch.float32)
        return ref.kernel_matvec_multi(
            a, b, v, sigmas, w_plain, kernels=kernels, chunk_a=chunk_a, chunk_b=chunk_b,
            precision=precision,
        )
    return kernel_matvec_multi_cuda(a, b, v, weights, kernels=kernels, sigmas=sigmas,
                                    precision=precision)


def kernel_matvec_components(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    *,
    kernels: tuple[str, ...],
    sigmas: tuple[float, ...],
    chunk_a: int = 4096,
    chunk_b: int = 8192,
    precision: str = "f32",
) -> torch.Tensor:
    """Stacked per-kernel products (q, m[, t]): out[i] = K_i(a, b) @ v, one
    data sweep for all q (the multi-kernel tuner's per-kernel sketches)."""
    kernels, sigmas, precision = _multi_spec(kernels, sigmas, precision)
    route = _route(a, b, v)
    if route == "meta":
        m, n, d, t = _dims(a, b, v)
        return _meta_result("kernel_matvec_components", (len(kernels), m) + tuple(v.shape[1:]),
                            analyze.multi_kernel_cost(m, n, d, t, kernels, "components"))
    if route == "cpu":
        return ref.kernel_matvec_components(
            a, b, v, sigmas, kernels=kernels, chunk_a=chunk_a, chunk_b=chunk_b,
            precision=precision,
        )
    return kernel_matvec_components_cuda(a, b, v, kernels=kernels, sigmas=sigmas,
                                         precision=precision)


def kernel_block_multi(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    kernels: tuple[str, ...],
    sigmas: tuple[float, ...],
    weights: tuple[float, ...],
    precision: str = "f32",
) -> torch.Tensor:
    """Materialize sum_i w_i K_i(a, b) (small/medium blocks only)."""
    kernels, sigmas, precision = _multi_spec(kernels, sigmas, precision)
    weights = tuple(float(w) for w in weights)
    if len(weights) != len(kernels):
        raise ValueError(f"{len(weights)} weights for {len(kernels)} kernels")
    route = _route(a, b)
    if route == "meta":
        m, n, d, _ = _dims(a, b)
        return _meta_result("kernel_block_multi", (m, n),
                            analyze.multi_kernel_cost(m, n, d, 0, kernels, "block"))
    if route == "cpu":
        return ref.kernel_block_multi(a, b, sigmas, weights, kernels=kernels, precision=precision)
    return kernel_block_multi_cuda(a, b, kernels=kernels, sigmas=sigmas, weights=weights,
                                   precision=precision)


def launches() -> dict[str, int]:
    """CUDA kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
