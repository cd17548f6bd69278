"""Deterministic data partitioners for the divide-and-conquer solve tier —
the port of ``repro.distributed.partition``.

DC-KRR (You, Demmel, Hsieh & Vuduc 2018) partitions the training set into k
shards, solves full local KRR per shard and combines the predictions.  The
partition is a first-class, serializable object:

  * :func:`random_partition` — a seeded permutation split into k
    size-balanced shards (sizes differ by at most one row).
  * :func:`kmeans_partition` — chunked Lloyd iterations over the squared-
    distance expansion the kernel tiles use (``core.kernels._sq_dists``,
    streamed in row chunks), then a capacity-constrained greedy assignment
    that restores exact size balance (most-confident points claim their
    nearest center first).

Both draw from ``np.random.default_rng(seed)`` exactly as the JAX package
does, so the same ``(x, k, seed)`` gives the same assignments in both
packages.  :meth:`Partition.to_json` / :meth:`Partition.from_json` are the
one format both packages read.  At k = 1 every partitioner is the identity
(one shard holding rows ``0..n-1`` in order).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.kernels import _sq_dists

#: accepted partitioner kinds (the ``dc_partition=`` vocabulary)
PARTITION_KINDS = ("random", "kmeans")


def balanced_sizes(n: int, k: int) -> np.ndarray:
    """Shard sizes for n rows over k shards, balanced to within one row:
    the first ``n % k`` shards get ``n // k + 1`` rows, the rest ``n // k``."""
    if not (isinstance(k, (int, np.integer)) and 1 <= k <= n):
        raise ValueError(
            f"shard count k = {k!r} invalid for n = {n}; accepted: "
            f"integers in [1, n]"
        )
    base, rem = divmod(n, k)
    return np.asarray([base + (j < rem) for j in range(k)], np.int64)


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def _on_own_device(a) -> torch.Tensor:
    """``a`` as an f32 tensor on its own device (a host array on the CPU)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def chunked_sq_dists(x, centers, chunk: int = 4096) -> np.ndarray:
    """Pairwise squared distances ``||x_i - c_j||^2`` as a host (n, k) f32
    array, streamed in row chunks of ``x`` through the kernel tiles'
    expansion (``core.kernels._sq_dists``) on x's device: k is small (the
    shard count), so (n, k) is the only materialized object and the only
    one copied to the host."""
    x = _on_own_device(x)
    c = torch.from_numpy(np.ascontiguousarray(_host_f32(centers))).to(x.device)
    n = x.shape[0]
    out = torch.empty((n, c.shape[0]), dtype=torch.float32, device=x.device)
    for lo in range(0, n, chunk):
        out[lo:lo + chunk] = _sq_dists(x[lo:lo + chunk], c)
    return out.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class Partition:
    """A size-balanced assignment of n rows to k shards, plus shard centers.

    ``assignments``: (n,) int32 shard ids; ``centers``: (k, d) f32 shard
    means (the softmax combiner's anchors); ``kind``/``seed``: provenance.
    """

    assignments: np.ndarray
    centers: np.ndarray
    kind: str
    seed: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "assignments", np.asarray(self.assignments, np.int32))
        object.__setattr__(self, "centers", np.asarray(self.centers, np.float32))
        if self.assignments.ndim != 1 or self.centers.ndim != 2:
            raise ValueError(
                f"Partition wants (n,) assignments and (k, d) centers; got "
                f"{self.assignments.shape} and {self.centers.shape}"
            )
        k = self.centers.shape[0]
        if self.assignments.size and not (
            0 <= int(self.assignments.min()) and int(self.assignments.max()) < k
        ):
            raise ValueError(f"assignments reference shard ids outside [0, {k})")

    @property
    def n(self) -> int:
        """Number of partitioned rows."""
        return int(self.assignments.shape[0])

    @property
    def k(self) -> int:
        """Number of shards."""
        return int(self.centers.shape[0])

    @property
    def sizes(self) -> np.ndarray:
        """(k,) rows per shard."""
        return np.bincount(self.assignments, minlength=self.k).astype(np.int64)

    def shard_indices(self) -> tuple[np.ndarray, ...]:
        """Per-shard row indices, each sorted ascending (so the k = 1
        partition reproduces the original row order exactly)."""
        order = np.argsort(self.assignments, kind="stable")
        bounds = np.cumsum(self.sizes)[:-1]
        return tuple(np.sort(piece) for piece in np.split(order, bounds))

    def to_json(self) -> str:
        """Serialize to a JSON string (assignments, centers, kind, seed)."""
        return json.dumps({
            "kind": self.kind,
            "seed": int(self.seed),
            "assignments": self.assignments.tolist(),
            "centers": self.centers.tolist(),
        })

    @classmethod
    def from_json(cls, payload: str) -> "Partition":
        """Inverse of :meth:`to_json`; f32 centers survive the f64 JSON
        detour exactly."""
        obj = json.loads(payload)
        return cls(
            assignments=np.asarray(obj["assignments"], np.int32),
            centers=np.asarray(obj["centers"], np.float32),
            kind=obj["kind"],
            seed=int(obj["seed"]),
        )


def _centers_of(x: np.ndarray, assignments: np.ndarray, k: int) -> np.ndarray:
    centers = np.empty((k, x.shape[1]), np.float32)
    for j in range(k):
        centers[j] = x[assignments == j].mean(axis=0)
    return centers


def random_partition(x, k: int, seed: int = 0) -> Partition:
    """Seeded uniform partition into k size-balanced shards: a permutation
    of ``range(n)`` split into the :func:`balanced_sizes` pieces; centers
    are the per-shard feature means."""
    x = _host_f32(x)
    n = x.shape[0]
    sizes = balanced_sizes(n, k)
    assignments = np.empty(n, np.int32)
    perm = np.random.default_rng(seed).permutation(n)
    start = 0
    for j, s in enumerate(sizes):
        assignments[perm[start : start + s]] = j
        start += s
    return Partition(assignments=assignments, centers=_centers_of(x, assignments, k),
                     kind="random", seed=seed)


def kmeans_partition(x, k: int, seed: int = 0, *, iters: int = 10,
                     chunk: int = 4096) -> Partition:
    """Chunked, capacity-balanced k-means partition into k shards.

    Lloyd iterations over :func:`chunked_sq_dists`; centers seed from k
    distinct random rows.  The final assignment gives every shard exactly
    its :func:`balanced_sizes` quota: points claim centers in decreasing
    order of confidence (the margin between best and second-best center),
    each taking the nearest center with spare capacity.
    """
    x_dev = _on_own_device(x)  # the distances run where x lies
    x = _host_f32(x)
    n = x.shape[0]
    sizes = balanced_sizes(n, k)
    rng = np.random.default_rng(seed)
    centers = x[np.sort(rng.choice(n, size=k, replace=False))].copy()
    for _ in range(max(int(iters), 0)):
        assign = chunked_sq_dists(x_dev, centers, chunk).argmin(axis=1)
        new_centers = centers.copy()
        for j in range(k):
            mask = assign == j
            if mask.any():  # empty clusters keep their previous center
                new_centers[j] = x[mask].mean(axis=0)
        if np.array_equal(new_centers, centers):
            break
        centers = new_centers

    d2 = chunked_sq_dists(x_dev, centers, chunk)
    pref = np.argsort(d2, axis=1, kind="stable")  # (n, k) nearest-first
    if k > 1:
        top2 = np.sort(d2, axis=1)[:, :2]
        margin = top2[:, 1] - top2[:, 0]
    else:
        margin = np.zeros(n, np.float32)
    order = np.argsort(-margin, kind="stable")  # most-confident first
    remaining = sizes.copy()
    assignments = np.empty(n, np.int32)
    for i in order:
        for j in pref[i]:
            if remaining[j] > 0:
                assignments[i] = j
                remaining[j] -= 1
                break
    return Partition(assignments=assignments, centers=_centers_of(x, assignments, k),
                     kind="kmeans", seed=seed)


def make_partition(x, k: int, kind: str = "random", seed: int = 0) -> Partition:
    """Dispatch on :data:`PARTITION_KINDS` — the ``dc_partition=`` entry
    point behind ``solve(method="dc")``."""
    if kind == "random":
        return random_partition(x, k, seed)
    if kind == "kmeans":
        return kmeans_partition(x, k, seed)
    raise ValueError(
        f"unknown partition kind {kind!r}; accepted: {PARTITION_KINDS} "
        f"or a Partition instance"
    )
