"""Batched KRR prediction serving — the port of ``repro.serving.krr_serve``.

Wraps a trained weight matrix behind a kernel operator so solved KRR models
can serve request traffic.  Requests are padded to power-of-two buckets (at
least 8 rows, at most ``max_batch``) and each bucket is one
``row_block_matvec`` K(x_query, X_train) @ w serving all t one-vs-all
heads at once.  PyTorch runs eagerly, so there is no jit cache to bound;
the ladder stays all the same, so the launch shapes (and the warmed-bucket
count of ``serving.engine``) are the JAX package's.  On the card every
bucket is one launch of the CUDA ``kernel_matvec`` (or, for a kernel list,
the weighted matvec); at t = 1 and up to 4096 rows that launch splits the
training rows over the grid, so a bucket of a few queries still fills the
card and a row's score does not depend on the bucket it rides in.

The operator may also be a ``ShardedKernelOperator`` over a
``SolverMesh`` (``make_sharded_krr_predict_fn``, or ``mesh=`` on the config
path): both expose the same ``row_block_matvec(a, v)``, so the same closure
serves a row-sharded model.  Queries stay replicated, the training rows and
weights stay row-sharded, and per bucket the only cross-device traffic is
the psum of the (bucket, t) partial scores.

``make_krr_predict_fn_from_config`` builds the closure straight from the
best-config dict ``solver_api.tune()`` exports, closing the tune -> refit
-> serve loop.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels import KERNEL_NAMES
from repro_torch.core.multikernel import make_operator
from repro_torch.core.operator import KernelOperator
from repro_torch.device import resolve_device
from repro_torch.kernels.precision import check_precision

#: smallest bucket: requests are padded up to at least this many rows
MIN_BUCKET = 8


def bucket_for(q: int, max_batch: int) -> int:
    """Bucket (padded row count) serving a ``q``-row block: the next power of
    two >= max(q, 8), capped at ``max_batch``."""
    b = MIN_BUCKET
    while b < q:
        b <<= 1
    return min(b, max_batch)


def _host_to(a, dev: torch.device) -> torch.Tensor:
    """``a`` (array or tensor) on ``dev``; float64 becomes float32, as a
    JAX array does without x64."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(dev)


def make_krr_predict_fn(op, w: torch.Tensor, *, max_batch: int = 4096):
    """Batched KRR scorer: (q, d) queries -> (q,) or (q, t) scores.

    ``op`` is an operator over the training rows (``KernelOperator``,
    ``WeightedSumKernelOperator`` or ``PrecomputedKernelOperator``), ``w``
    the solved weights ((n,) or (n, t)) on its device.  The closure takes a
    tensor (or array) of queries, moves it to ``w``'s device, pads each
    request up to the next power-of-two bucket (>= 8, <= max_batch) and
    streams oversize requests in max_batch chunks; one fused kernel pass
    serves all heads.  The scores stay on the device.
    """

    def predict(xq) -> torch.Tensor:
        xq = _host_to(xq, w.device)
        q = xq.shape[0]
        if q == 0:  # empty request: (0,) / (0, t) without a launch
            return torch.zeros((0,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
        outs = []
        for start in range(0, q, max_batch):
            chunk = xq[start:start + max_batch]
            b = bucket_for(chunk.shape[0], max_batch)
            padded = chunk.new_zeros((b,) + tuple(xq.shape[1:]))
            padded[: chunk.shape[0]] = chunk
            outs.append(op.row_block_matvec(padded, w)[: chunk.shape[0]])
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    return predict


def make_sharded_krr_predict_fn(mesh, x_train, w, *, kernel="rbf", sigma=1.0, weights=None,
                                precision: str = "f32", max_batch: int = 4096):
    """Serve all t heads from row-sharded training rows on ``mesh`` (a
    ``SolverMesh``).

    Binds ``x_train`` row-sharded, places ``w`` (its global view on the
    mesh's home device) and returns the batched closure of
    :func:`make_krr_predict_fn`: per bucket the only cross-device traffic is
    the (bucket, t) psum of the partial scores.  A (1, 1) mesh is the
    single-device server.  A kernel TUPLE (+ ``weights``) serves the
    weighted-sum predictor.
    """
    from repro_torch.distributed.sharded_operator import ShardedKernelOperator

    op = ShardedKernelOperator.bind(
        mesh, _host_to(x_train, mesh.home), kernel=kernel, sigma=sigma,
        weights=weights, precision=precision,
    )
    return make_krr_predict_fn(op, _host_to(w, mesh.home), max_batch=max_batch)


def bind_operator_from_config(config: dict, x_train, w, *, mesh=None, device="cuda"):
    """Resolve a ``tune()`` best-config export into ``(operator, w)`` on
    ``device``.

    The shared reconstruction step behind :func:`make_krr_predict_fn_from_config`
    and the serving engine's model registry (``serving.engine``): checks the
    kernel names (``"precomputed"`` included: ``x_train`` is then the train
    Gram), parses the kernel / sigma / weights triple (single- or
    multi-kernel, a per-kernel sigma list), validates ``precision`` with
    ``check_precision`` (an unknown policy fails here with the accepted
    list), and builds the operator through ``core.multikernel.make_operator``
    or, with ``mesh=`` (a ``SolverMesh``), a row-sharded
    ``ShardedKernelOperator`` with ``w`` on the mesh's home device.
    ``backend`` is read and ignored: the port dispatches by device.
    ``device="cuda"`` without a card raises.
    """
    kernel = config["kernel"]
    sigma = config["sigma"]
    weights = config.get("weights")
    # fail fast on kernel names (a hand-edited export, or one from a newer
    # zoo than this server); "precomputed" is valid: x_train is the Gram
    names = kernel if isinstance(kernel, (tuple, list)) else (kernel,)
    for k in names:
        if k not in KERNEL_NAMES and k != "precomputed":
            raise ValueError(
                f"unknown kernel {k!r} in serving config; available: "
                f"{KERNEL_NAMES + ('precomputed',)}"
            )
    if isinstance(kernel, (tuple, list)):
        kernel = tuple(kernel)
        sigma = (
            tuple(float(s) for s in sigma)
            if isinstance(sigma, (tuple, list)) else float(sigma)
        )
        if weights is not None:
            weights = tuple(float(v) for v in weights)
    else:
        sigma = float(sigma)
    precision = check_precision(config.get("precision", "f32"))
    if mesh is not None:
        if kernel == "precomputed":
            raise ValueError(
                "kernel='precomputed' cannot serve over a mesh: the Gram "
                "matrix has no row-sharded kernel evaluation path"
            )
        from repro_torch.distributed.sharded_operator import ShardedKernelOperator

        op = ShardedKernelOperator.bind(
            mesh, _host_to(x_train, mesh.home), kernel=kernel, sigma=sigma,
            weights=weights, precision=precision,
        )
        return op, _host_to(w, mesh.home)
    dev = resolve_device(device)
    op = make_operator(_host_to(x_train, dev), kernel=kernel, sigma=sigma, weights=weights,
                       precision=precision)
    return op, _host_to(w, dev)


def make_krr_predict_fn_from_config(config: dict, x_train, w, *, mesh=None,
                                    max_batch: int = 4096, device="cuda"):
    """Serve a refit model from a ``tune()`` best-config export.

    Args:
      config: the JSON-able dict ``TuneResult.best`` carries (or a CLI
        ``--export`` file re-read): requires ``kernel`` and ``sigma``;
        ``precision`` ("f32" | "bf16") is honored when present, an unknown
        one raises ValueError with the accepted list.  A multi-kernel export
        carries ``kernel`` as a list of names plus ``weights`` (and possibly
        a per-kernel ``sigma`` list).  Extra keys (``lam_unscaled``,
        ``cv_mse``, ``folds``, ``backend``, ``trace``) are ignored.
      x_train: (n, d) training rows the weights were fit on (array or tensor).
      w: the refit weights, (n,) or (n, t).
      mesh: optional ``SolverMesh``: serve from row-sharded training rows.
      device: where the rows, weights and every bucket pass live.

    Returns:
      The batched predict closure of :func:`make_krr_predict_fn`.
    """
    op, w = bind_operator_from_config(config, x_train, w, mesh=mesh, device=device)
    return make_krr_predict_fn(op, w, max_batch=max_batch)


__all__ = [
    "KernelOperator",
    "MIN_BUCKET",
    "bucket_for",
    "bind_operator_from_config",
    "make_krr_predict_fn",
    "make_krr_predict_fn_from_config",
    "make_sharded_krr_predict_fn",
]
