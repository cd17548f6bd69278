"""Plain PyTorch versions of the fused kernel ops.

These compute what the CUDA kernels compute, with ordinary tensor ops.  On
a CPU tensor they ARE the path (``ops`` dispatches here); on a CUDA tensor
they are used only by ``chip_smoke.py`` and the tests, to hold the kernels
against.  They stream over fixed-size chunk pairs, so K is never formed
beyond one (chunk_a, chunk_b) tile — the same contract as the kernels.

Precision policy (as ``repro.kernels.ref._cast_chunks`` / ``_acc_dot``):
``"bf16"`` rounds A/B/V to bf16; distances and maps are f32; the kernel
tile is rounded to bf16 before its product with V; accumulation is f32.
The bf16 product is taken as an f32 matmul of the bf16-rounded values
(each product of two bf16 values is exact in f32), so it does not depend
on how a backend implements a bf16 matmul.
"""

from __future__ import annotations

import torch

from repro_torch.core.kernels import kernel_matrix


def _cast(precision: str, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    if precision == "bf16":
        return tuple(x.to(torch.bfloat16) for x in xs)
    return xs


def _acc_dot(ktile: torch.Tensor, v_blk: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return ktile.to(torch.bfloat16).float() @ v_blk.float()
    dt = torch.promote_types(ktile.dtype, v_blk.dtype)
    return ktile.to(dt) @ v_blk.to(dt)


def kernel_matvec(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    sigma: float,
    *,
    kernel: str = "rbf",
    chunk_a: int = 4096,
    chunk_b: int = 8192,
    precision: str = "f32",
) -> torch.Tensor:
    """out = K(a, b) @ v, streamed over chunk pairs.

    a: (m, d), b: (n, d), v: (n,) | (n, t) -> (m,) | (m, t), at least f32.
    """
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    a, b, v2 = _cast(precision, a, b, v2)
    acc_dt = torch.promote_types(torch.promote_types(a.dtype, v2.dtype), torch.float32)
    m, n = a.shape[0], b.shape[0]
    out = torch.zeros((m, v2.shape[1]), dtype=acc_dt, device=a.device)
    for i in range(0, m, chunk_a):
        a_blk = a[i:i + chunk_a]
        for j in range(0, n, chunk_b):
            ktile = kernel_matrix(kernel, a_blk, b[j:j + chunk_b], sigma)
            out[i:i + chunk_a] += _acc_dot(ktile, v2[j:j + chunk_b], precision)
    return out[:, 0] if squeeze else out


def kernel_block(
    a: torch.Tensor,
    b: torch.Tensor,
    sigma: float,
    *,
    kernel: str = "rbf",
    precision: str = "f32",
) -> torch.Tensor:
    """Materialize K(a, b) (m, n), filled in (4096, 8192) chunk pairs so no
    temporary exceeds one tile.  ``"bf16"`` rounds the operands first."""
    a, b = _cast(precision, a, b)
    dt = torch.promote_types(a.dtype, torch.float32)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=dt, device=a.device)
    for i in range(0, a.shape[0], 4096):
        for j in range(0, b.shape[0], 8192):
            out[i:i + 4096, j:j + 8192] = kernel_matrix(kernel, a[i:i + 4096], b[j:j + 8192], sigma)
    return out
