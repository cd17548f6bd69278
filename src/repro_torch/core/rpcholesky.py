"""Randomly pivoted (partial) Cholesky — RPC (Diaz et al. 2023, Epperly et
al. 2024) — the port of ``repro.core.rpcholesky``.

A rank-r factor F (n x r) with K ~= F F^T, each pivot drawn in turn with
probability proportional to the diagonal of the residual kernel.  One of the
two PCG preconditioners the paper benchmarks against (Fig. 1, rank 50).

Each pivot costs one (n, 1) kernel column, ``op.block(x, x[piv])``.  The
pivot stays a device tensor from its draw (``torch.multinomial``) to its
use, so the loop never reads a device value on the host.
"""

from __future__ import annotations

import torch


def rp_cholesky(
    generator: torch.Generator | None,
    op,
    rank: int,
    *,
    pivots: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (F, pivots): F (n, rank) with K ~= F F^T.

    ``op`` owns the kernel configuration; one pivot per round, drawn from
    ``generator`` unless ``pivots`` (rank,) injects them.  The kernels used
    here have unit diagonal, so diag(K) = 1 initially.
    """
    x = op.x
    n = op.n
    dev = x.device
    diag = torch.ones((n,), dtype=torch.float32, device=dev)
    f = torch.zeros((n, rank), dtype=torch.float32, device=dev)
    piv_out = torch.zeros((rank,), dtype=torch.int64, device=dev)
    for i in range(rank):
        if pivots is None:
            probs = torch.clamp_min(diag, 0.0)
            piv = torch.multinomial(probs, 1, generator=generator)
        else:
            piv = pivots[i:i + 1].to(device=dev, dtype=torch.int64)
        col = op.block(x, x.index_select(0, piv))[:, 0]
        # subtract the projection onto the factors found so far
        col = col - f @ f.index_select(0, piv)[0]
        denom = torch.sqrt(torch.clamp_min(col.index_select(0, piv), 1e-12))
        newcol = col / denom
        f[:, i] = newcol
        diag = torch.clamp_min(diag - newcol * newcol, 0.0)
        piv_out[i:i + 1] = piv
    return f, piv_out
