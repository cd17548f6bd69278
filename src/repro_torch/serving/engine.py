"""KRR serving engine — request coalescing over the bucketed batch path, a
hot-loadable multi-model registry, and per-model latency stats; the port of
``repro.serving.engine``.

``serving.krr_serve`` gives one model a batched predict closure; this module
turns it into a server.  Three layers:

* **Coalescing batcher** — clients submit (q_i, d) query blocks from any
  thread (:meth:`ServingEngine.submit` returns a future); one worker thread
  drains the shared queue under a ``max_wait_ms`` deadline, concatenates
  every queued request for the same model on the host, pads the union to
  the next power-of-two bucket and runs ONE ``row_block_matvec`` for all
  requests and all t heads (on the card, one launch of the CUDA
  ``kernel_matvec`` or weighted matvec), then scatters per-request row
  slices back to the futures.

* **Model registry** — :meth:`ServingEngine.register` (or
  :meth:`ServingEngine.load_model` from a :func:`save_model_artifact`
  directory: ``config.json`` + ``weights.npz``, the JAX package's layout,
  so each package serves the other's artifacts) binds the operator with
  ``krr_serve.bind_operator_from_config`` and **warms every bucket**: one
  pass of each size, so the kernel libraries are built and loaded and the
  allocator holds the scratch before any client arrives.  Re-registering a
  name hot-swaps it: requests already submitted finish on the old model
  (they hold a reference), new submissions see the new version.  A
  ``max_bytes`` budget LRU-evicts idle models.

* **Per-model stats** — request count, qps, p50/p99 latency, a
  batch-occupancy histogram per bucket, and ``compile_cache_depth`` (the
  bucket shapes launched), as a plain dict (:meth:`ServingEngine.stats`)
  with the JAX engine's keys.

Results are bitwise-identical to per-request ``predict`` calls at f32: each
output row of a bucket pass depends only on its own query row (on the card
the t = 1 sweep splits the training rows the same way for every bucket up
to 4096 rows), so coalescing changes throughput, never values.

The engine runs on the card unless ``device="cpu"`` is passed; a CUDA
engine without a card raises.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS_MS,
    Histogram,
    _render_series,
    record_tile_work,
)
from repro_torch.obs.metrics import counter as _obs_counter
from repro_torch.obs.metrics import gauge as _obs_gauge
from repro_torch.obs.telemetry import as_telemetry
from repro_torch.serving.krr_serve import MIN_BUCKET, bind_operator_from_config, bucket_for

ARTIFACT_CONFIG = "config.json"
ARTIFACT_WEIGHTS = "weights.npz"


def bucket_sizes(max_batch: int) -> tuple[int, ...]:
    """The power-of-two bucket ladder for ``max_batch``: 8, 16, ... capped at
    (and always including) ``max_batch`` — every shape a warmed model
    launches, O(log max_batch) entries."""
    sizes = []
    b = MIN_BUCKET
    while b < max_batch:
        sizes.append(b)
        b <<= 1
    sizes.append(max_batch)
    return tuple(sizes)


def _host(a) -> np.ndarray:
    """``a`` as a host numpy array (a CUDA tensor is copied back)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_model_artifact(path: str, config: dict, x_train, w) -> str:
    """Write a serving artifact directory: ``config.json`` + ``weights.npz``.

    ``config`` is the ``tune()`` best-config dict (extra keys ride along
    untouched); ``x_train`` the (n, d) training rows and ``w`` the refit
    weights ((n,) or (n, t)), numpy arrays or tensors (saved as numpy).
    The layout is the JAX package's, so either package loads it.  Returns
    ``path``.
    """
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ARTIFACT_CONFIG), "w") as fh:
        json.dump(config, fh, indent=2, default=float)
    np.savez(os.path.join(path, ARTIFACT_WEIGHTS), x_train=_host(x_train), w=_host(w))
    return path


def load_model_artifact(path: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """Read a :func:`save_model_artifact` directory -> (config, x_train, w)."""
    with open(os.path.join(path, ARTIFACT_CONFIG)) as fh:
        config = json.load(fh)
    with np.load(os.path.join(path, ARTIFACT_WEIGHTS)) as npz:
        x_train, w = npz["x_train"], npz["w"]
    return config, x_train, w


class _ModelEntry:
    """One registered model: bound operator + weights on the device + its
    slice of the stats.  Requests hold a direct reference, so an entry keeps
    serving its in-flight traffic even after being swapped or evicted."""

    def __init__(self, name: str, version: int, config: dict, op, w: torch.Tensor,
                 max_batch: int):
        self.name = name
        self.version = version
        self.config = config
        self.op = op
        self.w = w
        self.max_batch = max_batch
        self.d = int(op.d)
        self.out_trailing = tuple(w.shape[1:])
        self.dtype = torch.empty((0,), dtype=w.dtype).numpy().dtype
        self.x_dtype = op.x.dtype
        self.nbytes = int(op.n) * self.d * op.x.element_size() + w.numel() * w.element_size()
        self.warmed: set[int] = set()
        # stats (mutated by the worker thread only; read under the engine lock)
        self.n_requests = 0
        self.n_rows = 0
        # bounded log-spaced latency histogram, a local instance (not the
        # global registry), so two engines serving a same-named model never
        # mix latencies
        self.latency_hist = Histogram(
            "repro_serving_latency_ms", labels=(("model", name),),
            help="request latency, submit to scatter (ms)",
            buckets=LATENCY_BUCKETS_MS,
        )
        self.occupancy: dict[int, list[int]] = {}  # bucket -> [runs, rows]
        self.t_first: float | None = None
        self.t_last: float | None = None
        self.last_used = time.monotonic()
        self.loaded_at = time.time()

    def score(self, padded: np.ndarray) -> np.ndarray:
        """One bucket pass: the host (b, d) block to the device, K(block,
        X_train) @ w, the scores back to the host (``.cpu()`` waits for the
        device).  Tracks the bucket shapes launched."""
        self.warmed.add(padded.shape[0])
        xq = torch.from_numpy(padded).to(device=self.w.device, dtype=self.x_dtype)
        return self.op.row_block_matvec(xq, self.w).cpu().numpy()

    def warm(self) -> tuple[int, ...]:
        """Launch every bucket of the ladder once (a zeros block each), so
        no client pays a library build, a first launch or an allocation."""
        for b in bucket_sizes(self.max_batch):
            self.score(np.zeros((b, self.d), np.float32))
        return bucket_sizes(self.max_batch)

    def stats(self) -> dict[str, Any]:
        """The per-model stats dict (see :meth:`ServingEngine.stats`); p50 /
        p99 are bucket-interpolated from the bounded latency histogram,
        ``mean_ms`` is exact."""
        span = (
            (self.t_last - self.t_first)
            if (self.t_first is not None and self.t_last is not None)
            else 0.0
        )
        return {
            "model": self.name,
            "version": self.version,
            "n_requests": self.n_requests,
            "n_rows": self.n_rows,
            "qps": (self.n_requests / span) if span > 0 else 0.0,
            "p50_ms": self.latency_hist.quantile(0.50),
            "p99_ms": self.latency_hist.quantile(0.99),
            "mean_ms": self.latency_hist.mean,
            "occupancy": {
                b: {"runs": r, "rows": rows,
                    "fill": rows / (r * b) if r else 0.0}
                for b, (r, rows) in sorted(self.occupancy.items())
            },
            "compile_cache_depth": len(self.warmed),
            "bytes": self.nbytes,
        }

    def reset_stats(self) -> None:
        """Zero this model's traffic stats (latency histogram, counts,
        occupancy, qps span); warmed buckets and the registry entry stay."""
        self.n_requests = 0
        self.n_rows = 0
        self.latency_hist.reset()
        self.occupancy = {}
        self.t_first = None
        self.t_last = None


class _Request:
    __slots__ = ("entry", "xq", "future", "t_arrival")

    def __init__(self, entry: _ModelEntry, xq, t_arrival: float):
        self.entry = entry
        self.xq = xq
        self.future: Future = Future()
        self.t_arrival = t_arrival


class ServingEngine:
    """Multi-model KRR serving engine (see the module docstring for the
    three layers).  Thread-safe: any number of client threads may
    ``submit``/``predict`` concurrently; one worker thread owns the bucket
    passes.

    Args:
      max_batch: largest bucket (and the coalescing drain cap).
      max_wait_ms: how long the worker holds the FIRST queued request open
        for co-travellers before closing the batch (0 coalesces only bursts
        already queued).
      max_bytes: optional registry memory budget over (x_train + w) bytes;
        registering past it LRU-evicts idle models.  A single model larger
        than the budget is rejected.
      telemetry: optional ``repro_torch.obs.Telemetry``: the worker then
        emits a ``serve/batch`` span per batch and tile-work metrics per
        bucket pass (latency histograms, the queue-depth gauge and the
        bucket counters are always on).
      device: where every model's rows, weights and bucket passes live
        (``"cuda"``, the default, raises without a card).
    """

    def __init__(self, *, max_batch: int = 4096, max_wait_ms: float = 5.0,
                 max_bytes: int | None = None, telemetry=None, device="cuda"):
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.max_bytes = max_bytes
        self._tel = as_telemetry(telemetry)
        self._queue_gauge = _obs_gauge(
            "repro_serving_queue_depth",
            help="requests waiting in the coalescing queue",
        )
        self._models: dict[str, _ModelEntry] = {}
        self._lock = threading.Lock()
        self._queue: queue_mod.Queue[_Request] = queue_mod.Queue()
        self._inflight = 0
        self._evictions = 0
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name="krr-serving-worker", daemon=True
        )
        self._worker.start()

    # -- registry -------------------------------------------------------------

    def register(self, name: str, config: dict, x_train, w, *, mesh=None,
                 warm: bool = True) -> dict[str, Any]:
        """Bind and (hot-)register a model under ``name``.

        ``config``/``x_train``/``w`` are the ``make_krr_predict_fn_from_config``
        inputs (arrays or tensors, moved to the engine's device); ``mesh=``
        (a ``SolverMesh``) serves from training rows row-sharded over it
        instead, with the weights on its home device.  ``warm=True``
        launches every bucket before the model becomes visible.  If ``name``
        exists the new version replaces it atomically; in-flight requests
        finish on the old model.  Returns an info dict (version, d, bytes,
        warmed buckets, evicted names).
        """
        op, w_bound = bind_operator_from_config(config, x_train, w, mesh=mesh,
                                                device=self.device)
        with self._lock:
            version = (
                self._models[name].version + 1 if name in self._models else 1
            )
        entry = _ModelEntry(name, version, dict(config), op, w_bound, self.max_batch)
        if self.max_bytes is not None and entry.nbytes > self.max_bytes:
            raise ValueError(
                f"model {name!r} needs {entry.nbytes} bytes, above the "
                f"registry budget max_bytes={self.max_bytes}"
            )
        warmed: tuple[int, ...] = ()
        if warm:
            warmed = entry.warm()
        with self._lock:
            self._models[name] = entry
            evicted = self._evict_to_budget_locked(keep=name)
        return {
            "model": name,
            "version": version,
            "d": entry.d,
            "bytes": entry.nbytes,
            "warmed_buckets": list(warmed),
            "evicted": evicted,
        }

    def load_model(self, name: str, path: str, *, mesh=None,
                   warm: bool = True) -> dict[str, Any]:
        """:func:`load_model_artifact` + :meth:`register` in one call — the
        disk-to-serving path the ``krr_serve`` launcher uses."""
        config, x_train, w = load_model_artifact(path)
        return self.register(name, config, x_train, w, mesh=mesh, warm=warm)

    def load_artifacts_dir(self, path: str, *, mesh=None,
                           warm: bool = True) -> dict[str, dict[str, Any]]:
        """Register every artifact under ``path`` (registry persistence).

        Scans the immediate subdirectories of ``path`` for the
        :func:`save_model_artifact` layout and registers each under its
        directory name, in sorted order; anything else is ignored.  Returns
        ``{name: register-info}``; raises if ``path`` holds no artifact.
        """
        loaded: dict[str, dict[str, Any]] = {}
        for entry in sorted(os.listdir(path)):
            sub = os.path.join(path, entry)
            if not (
                os.path.isfile(os.path.join(sub, ARTIFACT_CONFIG))
                and os.path.isfile(os.path.join(sub, ARTIFACT_WEIGHTS))
            ):
                continue
            loaded[entry] = self.load_model(entry, sub, mesh=mesh, warm=warm)
        if not loaded:
            raise FileNotFoundError(
                f"no model artifacts ({ARTIFACT_CONFIG} + {ARTIFACT_WEIGHTS} "
                f"subdirectories) under {path!r}"
            )
        return loaded

    def unregister(self, name: str) -> None:
        """Drop ``name`` from the registry (in-flight requests finish)."""
        with self._lock:
            self._models.pop(name, None)

    def models(self) -> list[str]:
        """Currently registered model names (sorted)."""
        with self._lock:
            return sorted(self._models)

    def _evict_to_budget_locked(self, keep: str) -> list[str]:
        evicted: list[str] = []
        if self.max_bytes is None:
            return evicted
        total = sum(e.nbytes for e in self._models.values())
        while total > self.max_bytes and len(self._models) > 1:
            victim = min(
                (n for n in self._models if n != keep),
                key=lambda n: self._models[n].last_used,
            )
            total -= self._models[victim].nbytes
            del self._models[victim]
            evicted.append(victim)
            self._evictions += 1
        return evicted

    # -- the client surface ---------------------------------------------------

    def submit(self, name: str, xq) -> Future:
        """Enqueue a (q, d) query block for ``name``; returns a
        ``concurrent.futures.Future`` resolving to the (q,) or (q, t) host
        scores (numpy).  The worker stamps ``future.latency_ms`` (submit to
        scatter, after the device finished) before resolving it.  Safe from
        any thread; shape and model errors raise immediately."""
        if self._stop.is_set():
            raise RuntimeError("ServingEngine is shut down")
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise KeyError(
                    f"unknown model {name!r}; registered: {sorted(self._models)}"
                )
            entry.last_used = time.monotonic()
            self._inflight += 1
        # requests stay host-side numpy until the bucket pass: assembly and
        # scatter never touch the device, so the only launch shapes are the
        # O(log max_batch) buckets
        xq = _host(xq)
        if xq.ndim != 2 or xq.shape[1] != entry.d:
            with self._lock:
                self._inflight -= 1
            raise ValueError(
                f"expected a (q, {entry.d}) query block for model {name!r}, "
                f"got shape {tuple(xq.shape)}"
            )
        req = _Request(entry, xq, time.monotonic())
        if xq.shape[0] == 0:  # empty request: resolve without queueing
            req.future.latency_ms = 0.0
            req.future.set_result(np.zeros((0,) + entry.out_trailing, entry.dtype))
            with self._lock:
                self._inflight -= 1
            return req.future
        self._queue.put(req)
        return req.future

    def predict(self, name: str, xq):
        """Blocking convenience wrapper: ``submit(name, xq).result()``."""
        return self.submit(name, xq).result()

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every submitted request has been served (raises
        TimeoutError after ``timeout`` s)."""
        t0 = time.monotonic()
        while True:
            with self._lock:
                if self._inflight == 0:
                    return
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("serving queue did not drain in time")
            time.sleep(0.001)

    def shutdown(self) -> None:
        """Stop the worker loop (idempotent).  Queued requests are served
        first; the engine cannot be restarted."""
        self._stop.set()
        self._worker.join(timeout=10.0)

    def __enter__(self) -> "ServingEngine":
        """Context-manager support: ``with ServingEngine() as eng: ...``."""
        return self

    def __exit__(self, *exc) -> None:
        """Drain outstanding work, then shut the worker down."""
        try:
            self.drain()
        finally:
            self.shutdown()

    # -- stats ----------------------------------------------------------------

    def stats(self, name: str | None = None) -> dict[str, Any]:
        """Per-model serving stats.

        With ``name``: that model's dict — ``n_requests``, ``qps`` (completed
        requests over the first->last completion span), ``p50_ms``/``p99_ms``
        latency (submit to scatter), the per-bucket occupancy histogram
        ``{bucket: {runs, rows, fill}}``, ``compile_cache_depth`` (bucket
        shapes launched) and ``bytes``.  Without: ``{"models": {name: ...},
        "evictions", "bytes", "max_bytes"}``.
        """
        with self._lock:
            if name is not None:
                return self._models[name].stats()
            return {
                "models": {n: e.stats() for n, e in self._models.items()},
                "evictions": self._evictions,
                "bytes": sum(e.nbytes for e in self._models.values()),
                "max_bytes": self.max_bytes,
            }

    def reset_stats(self, name: str | None = None) -> None:
        """Zero traffic stats for one model, or for every registered model
        when ``name`` is None (a fresh measurement window); registered
        models, warmed buckets and the eviction count stay."""
        with self._lock:
            entries = (
                [self._models[name]] if name is not None
                else list(self._models.values())
            )
        for e in entries:
            e.reset_stats()

    def prometheus_text(self) -> str:
        """Per-model latency histograms and request / row totals in the
        Prometheus text exposition format, rendered from the same bounded
        histograms :meth:`stats` reads."""
        with self._lock:
            entries = sorted(self._models.items())
        lines: list[str] = []
        if entries:
            lines.append("# HELP repro_serving_latency_ms request latency, "
                         "submit to scatter (ms)")
            lines.append("# TYPE repro_serving_latency_ms histogram")
            for name, e in entries:
                lines.extend(_render_series(
                    "repro_serving_latency_ms", (("model", name),), e.latency_hist,
                ))
            lines.append("# TYPE repro_serving_requests_total counter")
            for name, e in entries:
                lines.append(
                    f'repro_serving_requests_total{{model="{name}"}} {float(e.n_requests)}'
                )
            lines.append("# TYPE repro_serving_rows_total counter")
            for name, e in entries:
                lines.append(
                    f'repro_serving_rows_total{{model="{name}"}} {float(e.n_rows)}'
                )
        return "\n".join(lines) + ("\n" if lines else "")

    # -- the worker loop ------------------------------------------------------

    def _run(self) -> None:
        while True:
            try:
                req = self._queue.get(timeout=0.05)
            except queue_mod.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = [req]
            rows = req.xq.shape[0]
            # hold the batch open for co-travellers until the deadline (or
            # until one max_batch bucket is full); an idle gap of max_wait / 5
            # flushes early, so a lone request does not pay the full wait
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            idle_gap = self.max_wait_ms / 5e3
            while rows < self.max_batch:
                try:  # drain whatever is already queued without blocking
                    nxt = self._queue.get_nowait()
                except queue_mod.Empty:
                    wait = min(deadline - time.monotonic(), idle_gap)
                    if wait <= 0:
                        break
                    try:
                        nxt = self._queue.get(timeout=wait)
                    except queue_mod.Empty:
                        break
                batch.append(nxt)
                rows += nxt.xq.shape[0]
            self._queue_gauge.set(self._queue.qsize())
            by_entry: dict[int, list[_Request]] = {}
            for r in batch:
                by_entry.setdefault(id(r.entry), []).append(r)
            for reqs in by_entry.values():
                try:
                    self._serve_entry(reqs[0].entry, reqs)
                except Exception as exc:  # keep the worker alive: fail the batch's futures
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(exc)
                            with self._lock:
                                self._inflight -= 1

    def _serve_entry(self, entry: _ModelEntry, reqs: list[_Request]) -> None:
        lens = [r.xq.shape[0] for r in reqs]
        flat = reqs[0].xq if len(reqs) == 1 else np.concatenate([r.xq for r in reqs], axis=0)
        total = flat.shape[0]
        tel_enabled = self._tel.enabled
        precision = getattr(entry.op, "precision", "f32")
        outs = []
        start = 0
        with self._tel.span("serve/batch", model=entry.name,
                            requests=len(reqs), rows=total):
            while start < total:
                stop = min(start + entry.max_batch, total)
                b = bucket_for(stop - start, entry.max_batch)
                padded = np.zeros((b, entry.d), np.float32)
                padded[: stop - start] = flat[start:stop]
                # the one device round trip: a bucket shape in, host scores out
                out = entry.score(padded)[: stop - start]
                entry.occupancy.setdefault(b, [0, 0])
                entry.occupancy[b][0] += 1
                entry.occupancy[b][1] += stop - start
                labels = {"model": entry.name, "bucket": str(b)}
                _obs_counter("repro_serving_bucket_runs_total", labels,
                             help="fused bucket passes").inc()
                _obs_counter("repro_serving_bucket_rows_total", labels,
                             help="query rows served per bucket").inc(stop - start)
                if tel_enabled:
                    # one (bucket, n_train) kernel pass per run
                    record_tile_work(b, int(entry.op.n), entry.d, precision)
                outs.append(out)
                start = stop
        out = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
        t_done = time.monotonic()
        ofs = 0
        for r, ln in zip(reqs, lens):
            lat_ms = (t_done - r.t_arrival) * 1e3
            r.future.latency_ms = lat_ms
            r.future.set_result(out[ofs: ofs + ln])
            ofs += ln
            entry.latency_hist.observe(lat_ms)
        entry.n_requests += len(reqs)
        entry.n_rows += total
        if entry.t_first is None:
            entry.t_first = reqs[0].t_arrival
        entry.t_last = t_done
        with self._lock:
            self._inflight -= len(reqs)


__all__ = [
    "ARTIFACT_CONFIG",
    "ARTIFACT_WEIGHTS",
    "MIN_BUCKET",
    "ServingEngine",
    "bucket_for",
    "bucket_sizes",
    "load_model_artifact",
    "save_model_artifact",
]
