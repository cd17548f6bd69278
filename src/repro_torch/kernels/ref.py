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

from repro_torch.core.kernels import _FAMILY_TILES, _apply_kernel, kernel_family, kernel_matrix


def _cast(precision: str, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    if precision == "bf16":
        return tuple(x.to(torch.bfloat16) for x in xs)
    return xs


def _acc_dot(ktile: torch.Tensor, v_blk: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return ktile.to(torch.bfloat16).float() @ v_blk.to(torch.bfloat16).float()
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


# ---------------------------------------------------------------------------
# multi-kernel ops: ONE data sweep serves all q kernels.  The base tile is
# computed once per kernel family present (l2 / l1 / dot / cos) per chunk
# pair; the q elementwise kernel maps and the weighted accumulation ride the
# same chunks (the port of ``repro.kernels.ref``'s multi-kernel section).
# ---------------------------------------------------------------------------


def _multi_chunks(m: int, n: int, chunk_a: int, chunk_b: int):
    """The (row slice, column slice) chunk pairs of an (m, n) sweep, rows
    outer.  The slicing counterpart of the reference's ``_multi_chunks``
    padding: a ragged last chunk is cut short instead of zero-padded, which
    adds the same (zero) contribution."""
    chunk_a = min(chunk_a, max(m, 1))
    chunk_b = min(chunk_b, max(n, 1))
    for i in range(0, m, chunk_a):
        for j in range(0, n, chunk_b):
            yield slice(i, i + chunk_a), slice(j, j + chunk_b)


def _dist_tiles(a_blk: torch.Tensor, b_blk: torch.Tensor, kernels) -> dict:
    """One shared base tile per family present (dict family -> tile)."""
    return {
        fam: _FAMILY_TILES[fam](a_blk, b_blk)
        for fam in dict.fromkeys(kernel_family(k) for k in kernels)
    }


def tile_from_dists(kernel: str, tiles: dict, sigma: float) -> torch.Tensor:
    """The kernel's elementwise map applied to its family's shared tile."""
    return _apply_kernel(tiles[kernel_family(kernel)], kernel, sigma)


def kernel_matvec_multi(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    sigmas: tuple[float, ...],
    weights: torch.Tensor,
    *,
    kernels: tuple[str, ...],
    chunk_a: int = 4096,
    chunk_b: int = 8192,
    precision: str = "f32",
) -> torch.Tensor:
    """out = (sum_i w_i K_i(a, b)) @ v, streamed — one data sweep for all q.

    ``weights`` is (q,) or per-column (q, t): column c applies
    ``sum_i w[i, c] K_i``, computed as ``K_i (v * w_i)`` so one accumulator
    serves every kernel and column.  ``"bf16"`` rounds a/b/v to bf16, then
    each K_i tile and each ``v * w_i`` (weights stay f32) before their
    product, accumulated in f32.
    """
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    a, b, v2 = _cast(precision, a, b, v2)
    w_rows = weights[:, None, :] if weights.ndim == 2 else weights[:, None, None]
    acc_dt = torch.promote_types(torch.promote_types(a.dtype, v2.dtype), torch.float32)
    out = torch.zeros((a.shape[0], v2.shape[1]), dtype=acc_dt, device=a.device)
    for rows, cols in _multi_chunks(a.shape[0], b.shape[0], chunk_a, chunk_b):
        tiles = _dist_tiles(a[rows], b[cols], kernels)
        v_blk = v2[cols]
        for i, kn in enumerate(kernels):
            ktile = tile_from_dists(kn, tiles, sigmas[i])
            out[rows] += _acc_dot(ktile, v_blk * w_rows[i], precision)
    return out[:, 0] if squeeze else out


def kernel_matvec_components(
    a: torch.Tensor,
    b: torch.Tensor,
    v: torch.Tensor,
    sigmas: tuple[float, ...],
    *,
    kernels: tuple[str, ...],
    chunk_a: int = 4096,
    chunk_b: int = 8192,
    precision: str = "f32",
) -> torch.Tensor:
    """Stacked per-kernel products (q, m[, t]): out[i] = K_i(a, b) @ v.
    ``"bf16"`` rounds a/b/v and each K_i tile to bf16, accumulating in f32."""
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    a, b, v2 = _cast(precision, a, b, v2)
    acc_dt = torch.promote_types(torch.promote_types(a.dtype, v2.dtype), torch.float32)
    out = torch.zeros((len(kernels), a.shape[0], v2.shape[1]), dtype=acc_dt, device=a.device)
    for rows, cols in _multi_chunks(a.shape[0], b.shape[0], chunk_a, chunk_b):
        tiles = _dist_tiles(a[rows], b[cols], kernels)
        for i, kn in enumerate(kernels):
            out[i, rows] += _acc_dot(tile_from_dists(kn, tiles, sigmas[i]), v2[cols], precision)
    return out[:, :, 0] if squeeze else out


def kernel_block_multi(
    a: torch.Tensor,
    b: torch.Tensor,
    sigmas: tuple[float, ...],
    weights: tuple[float, ...],
    *,
    kernels: tuple[str, ...],
    precision: str = "f32",
) -> torch.Tensor:
    """Materialize sum_i w_i K_i(a, b) (m, n), the base tiles computed once
    per family in (4096, 8192) chunk pairs.  ``"bf16"`` rounds the
    operands; the weighted sum of the f32 tiles stays f32."""
    a, b = _cast(precision, a, b)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
    for rows, cols in _multi_chunks(a.shape[0], b.shape[0], 4096, 8192):
        tiles = _dist_tiles(a[rows], b[cols], kernels)
        for i, kn in enumerate(kernels):
            out[rows, cols] += weights[i] * tile_from_dists(kn, tiles, sigmas[i])
    return out
