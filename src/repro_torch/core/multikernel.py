"""WeightedSumKernelOperator — the KernelOperator contract over a convex
combination of base kernels (the port of ``repro.core.multikernel``).

``K_w = sum_i w_i K_i`` with per-kernel bandwidths.  Every primitive goes
through the fused multi-kernel ops (``repro_torch.kernels.ops.kernel_*_multi``):
one data sweep computes each family's base tile once and applies all q
kernel maps, so a q-kernel operator costs about one kernel sweep instead of
q.  Because the whole contract (``matvec`` / ``row_block_matvec`` / ``block``
/ ``block_idx`` / ``trace_est`` / ``restrict`` / ``with_points``) holds,
ASkotch and the tuner run multi-kernel unchanged; a ``KRRProblem`` with a
kernel *tuple* builds one through :func:`make_operator`.

Two extra primitives serve the multi-kernel tuner (``repro_torch.core.tune.
tune_multikernel``):

  * ``matvec_cols(v, w_cols)`` — per-COLUMN weight vectors (q, t): column c
    applies ``sum_i w_cols[i, c] K_i``, so every weight candidate of a
    random search is one more column of the same stacked solve.
  * ``sketch_components(omega)`` — stacked per-kernel sketches ``K_i Omega``
    (q, n, r) from one data sweep; a candidate's Nystrom sketch is their
    weighted combination.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.kernels import KERNEL_NAMES, kernel_diag
from repro_torch.core.operator import (
    KernelOperator,
    PrecomputedKernelOperator,
    widen_gram,
)
from repro_torch.kernels import ops


def canonical_kernels(
    kernels, sigma, weights=None
) -> tuple[tuple[str, ...], tuple[float, ...], tuple[float, ...]]:
    """Validate and normalize a multi-kernel spec.

    Args:
      kernels: sequence of q base-kernel names (each in ``KERNEL_NAMES``).
      sigma: one shared bandwidth (float) or a per-kernel sequence of q.
      weights: optional q nonnegative weights (``None`` -> uniform ``1/q``);
        NOT renormalized — callers own the simplex constraint.

    Returns:
      ``(kernels, sigmas, weights)`` as plain tuples of length q.
    """
    kernels = tuple(str(k) for k in kernels)
    if not kernels:
        raise ValueError("multi-kernel spec needs at least one kernel")
    for k in kernels:
        if k not in KERNEL_NAMES:
            raise ValueError(
                f"unknown kernel {k!r} in multi-kernel spec; available: "
                f"{KERNEL_NAMES}"
            )
    q = len(kernels)
    if isinstance(sigma, (tuple, list)):
        sigmas = tuple(float(s) for s in sigma)
        if len(sigmas) != q:
            raise ValueError(
                f"sigma has {len(sigmas)} entries for {q} kernels; pass one "
                f"shared float or exactly one per kernel"
            )
    else:
        sigmas = (float(sigma),) * q
    if any(s <= 0 for s in sigmas):
        raise ValueError(f"sigmas must be positive; got {sigmas}")
    if weights is None:
        w = (1.0 / q,) * q
    else:
        w = tuple(float(x) for x in weights)
        if len(w) != q:
            raise ValueError(
                f"weights has {len(w)} entries for {q} kernels"
            )
        if any(x < 0 for x in w) or sum(w) <= 0:
            raise ValueError(
                f"weights must be nonnegative with a positive sum; got {w}"
            )
    return kernels, sigmas, w


@dataclasses.dataclass(frozen=True)
class WeightedSumKernelOperator:
    """Linear-operator view of ``K_w = sum_i w_i K_i(x, x)``.

    ``sigma`` may be one shared bandwidth or a per-kernel tuple; ``weights``
    defaults to uniform ``1/q``.  All primitives are multi-RHS exactly like
    :class:`~repro_torch.core.operator.KernelOperator`.
    """

    x: torch.Tensor  # (n, d) row points
    kernels: tuple[str, ...] = ("rbf", "laplacian")
    sigma: float | tuple[float, ...] = 1.0
    weights: tuple[float, ...] | None = None
    chunk_a: int = 4096
    chunk_b: int = 8192
    precision: str = "f32"  # tile-compute policy: "f32" | "bf16"

    def __post_init__(self) -> None:
        ks, sg, w = canonical_kernels(self.kernels, self.sigma, self.weights)
        object.__setattr__(self, "kernels", ks)
        object.__setattr__(
            self, "sigma",
            sg[0] if all(s == sg[0] for s in sg) else sg,
        )
        object.__setattr__(self, "weights", w)

    # -- structure -----------------------------------------------------------

    @property
    def q(self) -> int:
        """Number of base kernels in the combination."""
        return len(self.kernels)

    @property
    def sigmas(self) -> tuple[float, ...]:
        """Per-kernel bandwidths (a shared float expands to length q)."""
        if isinstance(self.sigma, tuple):
            return self.sigma
        return (float(self.sigma),) * self.q

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
        """(n, n) — the shape of K_w(x, x) this operator applies."""
        return (self.n, self.n)

    def components(self) -> tuple[KernelOperator, ...]:
        """The q single-kernel operators of the combination (tests, naive
        reference paths; the fused ops never build these internally)."""
        return tuple(
            KernelOperator(
                x=self.x, kernel=k, sigma=s, chunk_a=self.chunk_a,
                chunk_b=self.chunk_b, precision=self.precision,
            )
            for k, s in zip(self.kernels, self.sigmas)
        )

    # -- derived operators ---------------------------------------------------

    def with_points(self, x_new: torch.Tensor) -> "WeightedSumKernelOperator":
        """Same kernel combination over a different row set."""
        return dataclasses.replace(self, x=x_new)

    def restrict(self, idx: torch.Tensor) -> "WeightedSumKernelOperator":
        """Operator over the sub-row-set ``x[idx]`` (centers, folds)."""
        return self.with_points(self.x.index_select(0, idx))

    def with_weights(self, weights) -> "WeightedSumKernelOperator":
        """Same kernels/bandwidths under a different weight vector."""
        return dataclasses.replace(self, weights=tuple(float(w) for w in weights))

    # -- the four primitives -------------------------------------------------

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """K_w(x, x) @ v; v: (n,) or (n, t) -> same leading-dim shape."""
        return self.row_block_matvec(self.x, v)

    def row_block_matvec(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """K_w(a, x) @ v streamed over x — one data sweep for all q kernels.
        The weights reach the kernel by value (no device copy)."""
        return ops.kernel_matvec_multi(
            a, self.x, v, kernels=self.kernels, sigmas=self.sigmas,
            weights=self.weights, chunk_a=self.chunk_a, chunk_b=self.chunk_b,
            precision=self.precision,
        )

    def block(self, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        """Materialize K_w(a, b) (b defaults to a).  Small tiles only."""
        b = a if b is None else b
        return ops.kernel_block_multi(
            a, b, kernels=self.kernels, sigmas=self.sigmas,
            weights=self.weights, precision=self.precision,
        )

    def block_idx(self, idx: torch.Tensor) -> torch.Tensor:
        """(K_w)_BB for a row-index block (Skotch/ASkotch step)."""
        xb = self.x.index_select(0, idx)
        return self.block(xb, xb)

    def trace_est(self) -> torch.Tensor:
        """tr K_w = sum_i w_i tr K_i, each exact via ``kernel_diag`` (= w_i n
        for the unit-diagonal kernels)."""
        return torch.stack([
            w * kernel_diag(k, self.x, s).sum()
            for k, s, w in zip(self.kernels, self.sigmas, self.weights)
        ]).sum()

    # -- composites shared by several solvers --------------------------------

    def k_lam_matvec(self, v: torch.Tensor, lam: torch.Tensor | float) -> torch.Tensor:
        """(K_w + lam I) @ v."""
        return self.matvec(v) + lam * v

    def sketch(self, omega: torch.Tensor) -> torch.Tensor:
        """K_w @ omega for a (n, r) test matrix (Nystrom sketches)."""
        return self.matvec(omega)

    # -- tuning-engine primitives --------------------------------------------

    def matvec_cols(self, v: torch.Tensor, w_cols: torch.Tensor) -> torch.Tensor:
        """Per-column-weighted matvec: out[:, c] = (sum_i w_cols[i, c] K_i) @ v[:, c].

        ``v``: (n, t), ``w_cols``: (q, t) on ``v``'s device.  Every weight
        candidate of a random search rides ONE stacked solve: each column
        carries its own weight vector, the data sweep is shared.
        """
        return self.row_block_matvec_cols(self.x, v, w_cols)

    def row_block_matvec_cols(
        self, a: torch.Tensor, v: torch.Tensor, w_cols: torch.Tensor
    ) -> torch.Tensor:
        """Per-column-weighted K(a, x) @ v for an arbitrary row block ``a``."""
        return ops.kernel_matvec_multi(
            a, self.x, v, kernels=self.kernels, sigmas=self.sigmas,
            weights=w_cols, chunk_a=self.chunk_a, chunk_b=self.chunk_b,
            precision=self.precision,
        )

    def sketch_components(self, omega: torch.Tensor) -> torch.Tensor:
        """Stacked per-kernel sketches (q, n, r): out[i] = K_i @ omega.

        One data sweep; a weight candidate's Nystrom sketch is then the
        weighted combination ``sum_i w_i out[i]`` — zero extra kernel work.
        """
        return self.row_block_components(self.x, omega)

    def row_block_components(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Stacked per-kernel K_i(a, x) @ v (q, b[, t]) for a row block."""
        return ops.kernel_matvec_components(
            a, self.x, v, kernels=self.kernels, sigmas=self.sigmas,
            chunk_a=self.chunk_a, chunk_b=self.chunk_b, precision=self.precision,
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

    A string ``kernel`` yields a plain :class:`KernelOperator`; a tuple/list
    yields a :class:`WeightedSumKernelOperator`; ``kernel="precomputed"``
    treats ``x`` as a user-supplied Gram matrix (raw square or already
    widened) and yields a :class:`PrecomputedKernelOperator` (``sigma`` is
    ignored — the Gram already encodes it).  ``KRRProblem.op`` routes
    through here, which is what makes multi-kernel solves work across the
    solver stack without solver changes.
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
        return WeightedSumKernelOperator(
            x=x, kernels=tuple(kernel), sigma=sigma, weights=weights,
            chunk_a=chunk_a, chunk_b=chunk_b, precision=precision,
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
