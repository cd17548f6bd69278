"""Dispatch for the fused kernel ops, by the tensor's device.

A CPU tensor runs the plain PyTorch version (``ref``); a CUDA tensor
launches the hand-written CUDA kernel (``kernel_matvec`` /
``kernel_block``), which raises on what it does not take.  There is no
fallback from one to the other.

Both entry points share the contract of ``repro.kernels.ops``: never form
K(a, b) beyond one tile, accumulate in f32, accept a multi-RHS value matrix
(an ``(n, t)`` v rides the same kernel tiles as an ``(n,)`` v), take
``precision="f32"|"bf16"``, and cast ``sigma`` once, here, to a Python float.

Solvers do not call these directly; they go through
``repro_torch.core.operator.KernelOperator``.
"""

from __future__ import annotations

import torch

from repro_torch.core.kernels import kernel_family
from repro_torch.kernels import ref
from repro_torch.kernels.kernel_block import kernel_block_cuda
from repro_torch.kernels.kernel_matvec import kernel_matvec_cuda
from repro_torch.kernels.precision import PRECISIONS, check_precision

__all__ = ["PRECISIONS", "check_precision", "kernel_matvec", "kernel_block", "reset_launches", "launches"]


def _route(*xs: torch.Tensor) -> str:
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"operands must all be on the CPU or all on CUDA; got {sorted(kinds)}")


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
    if _route(a, b, v) == "cpu":
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
    if _route(a, b) == "cpu":
        return ref.kernel_block(a, b, sigma, kernel=kernel, precision=precision)
    return kernel_block_cuda(a, b, kernel=kernel, sigma=sigma, precision=precision)


def launches() -> dict[str, int]:
    """CUDA kernel launches counted by each wrapper since the last reset."""
    return {
        "kernel_matvec": kernel_matvec_cuda.launches,
        "kernel_block": kernel_block_cuda.launches,
    }


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    kernel_matvec_cuda.launches = 0
    kernel_block_cuda.launches = 0
