"""Operator dispatch for a kernel spec (the port of ``repro.core.multikernel``).

Only the single-kernel and ``"precomputed"`` branches of
:func:`make_operator` are ported; a kernel tuple (the weighted-sum
multi-kernel operator) waits for the multi-kernel slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.core.operator import (
    KernelOperator,
    PrecomputedKernelOperator,
    widen_gram,
)


def make_operator(
    x: torch.Tensor,
    *,
    kernel: str | tuple[str, ...] = "rbf",
    sigma: float | tuple[float, ...] = 1.0,
    weights=None,
    chunk_a: int = 4096,
    chunk_b: int = 8192,
    precision: str = "f32",
):
    """Build the right operator for a kernel spec — the ONE dispatch point.

    A string ``kernel`` yields a :class:`KernelOperator`;
    ``kernel="precomputed"`` treats ``x`` as a Gram matrix (raw square or
    widened) and yields a :class:`PrecomputedKernelOperator`.  A tuple of
    kernel names raises ``NotImplementedError`` (multi-kernel slice).
    """
    if kernel == "precomputed":
        if weights is not None:
            raise ValueError(
                "weights= does not apply to kernel='precomputed'; pre-combine "
                "the Gram matrices instead"
            )
        return PrecomputedKernelOperator(
            x=widen_gram(x), chunk_a=chunk_a, chunk_b=chunk_b, precision=precision,
        )
    if isinstance(kernel, (tuple, list)):
        raise NotImplementedError(
            "multi-kernel (weighted-sum) operators are not yet ported to "
            "repro_torch; they arrive with the multi-kernel slice"
        )
    if weights is not None:
        raise ValueError(
            "weights= only applies to a multi-kernel spec (a tuple of kernel "
            f"names); got kernel={kernel!r}"
        )
    if isinstance(sigma, (tuple, list)):
        raise ValueError(
            "per-kernel sigma tuples only apply to a multi-kernel spec; got "
            f"kernel={kernel!r} with sigma={sigma!r}"
        )
    return KernelOperator(
        x=x, kernel=kernel, sigma=float(sigma), chunk_a=chunk_a,
        chunk_b=chunk_b, precision=precision,
    )
