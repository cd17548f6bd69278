"""KernelOperator — the single owner of (kernel, sigma, chunking, precision).

The port of ``repro.core.operator``.  An operator is a frozen view over a
row set ``x`` exposing the primitives the solver stack is built from:

  * ``matvec(v)``              — K(x, x) @ v, fused/streamed, never forms K.
  * ``row_block_matvec(a, v)`` — K(a, x) @ v for a row block ``a``
                                 (ASkotch's O(n b d) hot spot, prediction).
  * ``block(a, b)``            — materialize a K(a, b) tile.
  * ``trace_est()``            — tr K(x, x), exact via ``kernel_diag``.

There is no ``backend`` field: the kernel ops dispatch by the device of
``x`` (CPU -> plain PyTorch, CUDA -> the CUDA kernels).
:class:`PrecomputedKernelOperator` implements the same contract over a
user-supplied Gram matrix.  Everything is multi-RHS: ``v`` may be ``(n,)``
or ``(n, t)``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.kernels import kernel_diag
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class KernelOperator:
    """Linear-operator view of K = K(x, x) for a fixed kernel configuration."""

    x: torch.Tensor  # (n, d) row points
    kernel: str = "rbf"
    sigma: float = 1.0
    chunk_a: int = 4096
    chunk_b: int = 8192
    precision: str = "f32"  # tile-compute policy: "f32" | "bf16"

    @property
    def n(self) -> int:
        """Number of rows (training points) the operator spans."""
        return self.x.shape[0]

    @property
    def d(self) -> int:
        """Feature dimension of the row points."""
        return self.x.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        """(n, n) — the shape of K(x, x)."""
        return (self.n, self.n)

    def with_points(self, x_new: torch.Tensor) -> "KernelOperator":
        """Same kernel configuration over a different row set."""
        return dataclasses.replace(self, x=x_new)

    def restrict(self, idx: torch.Tensor) -> "KernelOperator":
        """Operator over the sub-row-set ``x[idx]``."""
        return self.with_points(self.x.index_select(0, idx))

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K(x, x) @ v; v: (n,) or (n, t) -> same leading-dim shape."""
        return self.row_block_matvec(self.x, v)

    def row_block_matvec(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """K(a, x) @ v streamed over x; a: (b, d), v: (n,)|(n, t)."""
        return ops.kernel_matvec(
            a, self.x, v, kernel=self.kernel, sigma=self.sigma,
            chunk_a=self.chunk_a, chunk_b=self.chunk_b, precision=self.precision,
        )

    def block(self, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        """Materialize K(a, b) (b defaults to a).  Small/medium tiles only."""
        b = a if b is None else b
        return ops.kernel_block(
            a, b, kernel=self.kernel, sigma=self.sigma, precision=self.precision,
        )

    def block_idx(self, idx: torch.Tensor) -> torch.Tensor:
        """K_BB for a row-index block (Skotch/ASkotch step)."""
        xb = self.x.index_select(0, idx)
        return self.block(xb, xb)

    def trace_est(self) -> torch.Tensor:
        """tr K, exact: the sum of ``kernel_diag``."""
        return kernel_diag(self.kernel, self.x, self.sigma).sum()

    def k_lam_matvec(self, v: torch.Tensor, lam: torch.Tensor | float) -> torch.Tensor:
        """(K + lam I) @ v."""
        return self.matvec(v) + lam * v

    def sketch(self, omega: torch.Tensor) -> torch.Tensor:
        """K @ omega for a (n, r) test matrix."""
        return self.matvec(omega)


@dataclasses.dataclass(frozen=True)
class PrecomputedKernelOperator:
    """The ``KernelOperator`` contract over a user-supplied Gram matrix.

    ``x`` holds "widened rows" ``(n, n0 + 1)``: row i is ``[K(point_i,
    original train set) | original index of point_i]``, so ``restrict`` is
    plain row slicing while ``block(a, b)`` recovers exact Gram entries.  Raw
    ``(b, n0)`` row blocks (e.g. K(test, train) at prediction) are accepted
    as ``a`` too.
    """

    x: torch.Tensor  # (n, n0 + 1) widened rows: [Gram profile | original index]
    chunk_a: int = 4096
    chunk_b: int = 8192
    precision: str = "f32"

    kernel = "precomputed"

    @property
    def n(self) -> int:
        """Number of rows this operator currently spans (after restriction)."""
        return self.x.shape[0]

    @property
    def n0(self) -> int:
        """Number of columns in the original Gram (the full train-set size)."""
        return self.x.shape[1] - 1

    @property
    def d(self) -> int:
        """Width of a RAW row block callers feed in (= n0)."""
        return self.n0

    @property
    def shape(self) -> tuple[int, int]:
        """(n, n) — the restricted Gram this operator applies."""
        return (self.n, self.n)

    def with_points(self, x_new: torch.Tensor) -> "PrecomputedKernelOperator":
        """Same Gram over a different widened row set."""
        return dataclasses.replace(self, x=x_new)

    def restrict(self, idx: torch.Tensor) -> "PrecomputedKernelOperator":
        """Operator over the sub-row-set ``x[idx]`` (plain row slicing)."""
        return self.with_points(self.x.index_select(0, idx))

    def _profile(self, a: torch.Tensor) -> torch.Tensor:
        if a.ndim != 2:
            raise ValueError(f"precomputed row block must be 2-D, got shape {tuple(a.shape)}")
        if a.shape[1] == self.n0 + 1:
            return a[:, :-1]
        if a.shape[1] == self.n0:
            return a
        raise ValueError(
            f"precomputed row block has {a.shape[1]} columns; expected "
            f"{self.n0} (raw Gram rows over the original train set) or "
            f"{self.n0 + 1} (widened rows)"
        )

    def _cols(self) -> torch.Tensor:
        return self.x[:, -1].to(torch.int64)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K(x, x) @ v over the stored Gram; v: (n,) or (n, t)."""
        return self.row_block_matvec(self.x, v)

    def row_block_matvec(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """K(a, x) @ v: gather ``a``'s profiles at this operator's original
        indices, one matmul."""
        v2, was_1d = as_multirhs(v)
        out = self._profile(a).index_select(1, self._cols()) @ v2
        return maybe_squeeze(out, was_1d)

    def block(self, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        """Materialize K(a, b) from stored Gram entries (b defaults to a);
        ``b`` must carry its index column (widened)."""
        b = a if b is None else b
        if b.shape[1] != self.n0 + 1:
            raise ValueError(
                "precomputed block() needs widened rows for the column "
                f"operand (index column present); got width {b.shape[1]}"
            )
        return self._profile(a).index_select(1, b[:, -1].to(torch.int64))

    def block_idx(self, idx: torch.Tensor) -> torch.Tensor:
        """K_BB for a row-index block (Skotch/ASkotch step)."""
        xb = self.x.index_select(0, idx)
        return self.block(xb, xb)

    def trace_est(self) -> torch.Tensor:
        """tr K(x, x), exact: gather each row's own diagonal entry."""
        diag = self.x[:, :-1].gather(1, self._cols()[:, None])[:, 0]
        return diag.to(torch.float32).sum()

    def k_lam_matvec(self, v: torch.Tensor, lam: torch.Tensor | float) -> torch.Tensor:
        """(K + lam I) @ v."""
        return self.matvec(v) + lam * v

    def sketch(self, omega: torch.Tensor) -> torch.Tensor:
        """K @ omega for a (n, r) test matrix."""
        return self.matvec(omega)


def widen_gram(gram: torch.Tensor) -> torch.Tensor:
    """Attach the index column that turns a raw (n, n) Gram into
    :class:`PrecomputedKernelOperator` rows (idempotent on widened input)."""
    if gram.ndim != 2:
        raise ValueError(
            f"precomputed kernel expects a 2-D Gram matrix, got shape {tuple(gram.shape)}"
        )
    n, c = gram.shape
    if c == n + 1:
        return gram
    if c != n:
        raise ValueError(f"precomputed Gram must be square, got shape {tuple(gram.shape)}")
    idx = torch.arange(n, dtype=gram.dtype, device=gram.device)[:, None]
    return torch.cat([gram, idx], dim=1)


def as_multirhs(v: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Canonicalize a RHS/iterate to (n, t); returns (v2d, was_1d)."""
    if v.ndim == 1:
        return v[:, None], True
    return v, False


def maybe_squeeze(v: torch.Tensor, was_1d: bool) -> torch.Tensor:
    """Undo :func:`as_multirhs` on outputs."""
    return v[:, 0] if was_1d else v
